"""Upsampling stacks of the depth heads (counterpart of
unidepth_tpu/nn/upsample.py).

V2's residual conv units and bilinear upsampler take NCHW maps. V1's
``CvnxtBlock`` takes channel-last (B, H, W, C) maps, so its LN -> pwconv1
-> GELU reads rows in place (kernel K2 on the card where its shape gate
holds, ``nn.layers.ln_linear_gelu``); its 7x7 depthwise conv reads them as
a channels-last NCHW view. ``ConvUpsample`` and V2old's
``ConvUpsampleShuffleResidual`` return flat tokens."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from unidepth_tpu_torch.nn.conv import Conv2d
from unidepth_tpu_torch.nn.layers import ln_linear_gelu
from unidepth_tpu_torch.ops.resize import resize


class ResidualConvUnit(nn.Module):
    """LeakyReLU -> conv -> LeakyReLU -> conv, scaled residual."""

    def __init__(self, dim: int, kernel_size: int = 3, layer_scale: float = 1.0, padding_mode: str = "zeros"):
        super().__init__()
        self.conv1 = Conv2d(dim, dim, kernel_size, padding_mode=padding_mode)
        self.conv2 = Conv2d(dim, dim, kernel_size, padding_mode=padding_mode)
        self.layer_scale = float(layer_scale)
        self.gamma = nn.Parameter(torch.full((1, dim, 1, 1), self.layer_scale)) if layer_scale > 0.0 else None

    def forward(self, x):
        out = self.conv1(F.leaky_relu(x, 0.01))
        out = self.conv2(F.leaky_relu(out, 0.01))
        if self.gamma is not None:
            out = out * self.gamma
        return out + x


class ResUpsampleBil(nn.Module):
    """``num_layers`` residual conv units, a 1x1 projection, and a bilinear
    2x upsample (align_corners=False)."""

    def __init__(
        self,
        hidden_dim: int,
        output_dim: int | None = None,
        num_layers: int = 2,
        kernel_size: int = 3,
        layer_scale: float = 1.0,
        padding_mode: str = "zeros",
    ):
        super().__init__()
        output_dim = output_dim if output_dim is not None else hidden_dim // 2
        self.convs = nn.ModuleList(
            [ResidualConvUnit(hidden_dim, kernel_size, layer_scale, padding_mode) for _ in range(num_layers)]
        )
        self.up = nn.Sequential(Conv2d(hidden_dim, output_dim, kernel_size=1, padding=0))

    def forward(self, x):
        for conv in self.convs:
            x = conv(x)
        x = self.up(x)
        h, w = x.shape[-2:]
        return resize(x, (2 * h, 2 * w), mode="bilinear", align_corners=False, channel_last=False)


class CvnxtBlock(nn.Module):
    """ConvNeXt block of the V1 decoder on (B, H, W, C): 7x7 depthwise conv
    (zeros), LN (eps 1e-5, torch's default) -> pwconv1 -> exact GELU,
    pwconv2, layer scale (init 1), residual."""

    def __init__(self, dim: int, expansion: int = 4):
        super().__init__()
        self.use_kernels = True
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.pwconv1 = nn.Linear(dim, expansion * dim)
        self.pwconv2 = nn.Linear(expansion * dim, dim)
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        y = self.dwconv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        y = self.pwconv2(ln_linear_gelu(self.norm, self.pwconv1, y, self.use_kernels))
        return x + y * self.gamma


class ConvUpsample(nn.Module):
    """V1 upsampler: two CvnxtBlocks, then a 1x1 conv to half the channels,
    a 2x bilinear upsample with align_corners=True
    (``nn.UpsamplingBilinear2d``) and a 3x3 conv. (B, h, w, C) -> (B, 4hw,
    C/2) tokens."""

    def __init__(self, hidden_dim: int, expansion: int = 4):
        super().__init__()
        self.convs = nn.ModuleList([CvnxtBlock(hidden_dim, expansion) for _ in range(2)])
        half = hidden_dim // 2
        self.up = nn.Sequential(
            Conv2d(hidden_dim, half, kernel_size=1, padding=0),
            nn.UpsamplingBilinear2d(scale_factor=2),
            Conv2d(half, half, kernel_size=3),
        )

    def forward(self, x):
        for conv in self.convs:
            x = conv(x)
        x = self.up(x.permute(0, 3, 1, 2))
        return x.flatten(2).transpose(1, 2)


class ConvUpsampleShuffleResidual(nn.Module):
    """V2old upsampler: two CvnxtBlocks, then a pixel shuffle (r = 2, torch's
    channel order c r r + i r + j, as the JAX reshape), a 7x7 depthwise
    conv, ReLU and a 3x3 conv to half the channels, plus a 1x1 residual
    projection upsampled bilinearly with align_corners=True (the reference's
    ``nn.UpsamplingBilinear2d``, run through ``resize`` in fp32 as JAX
    does). Zeros padding throughout. (B, h, w, C) -> (B, 4hw, C/2) tokens."""

    def __init__(self, hidden_dim: int, expansion: int = 4):
        super().__init__()
        self.convs = nn.ModuleList([CvnxtBlock(hidden_dim, expansion) for _ in range(2)])
        quarter, half = hidden_dim // 4, hidden_dim // 2
        self.up = nn.Sequential(
            nn.PixelShuffle(2),
            nn.Conv2d(quarter, quarter, 7, padding=3, groups=quarter),
            nn.ReLU(),
            Conv2d(quarter, half, kernel_size=3),
        )
        self.residual = nn.Sequential(Conv2d(hidden_dim, half, kernel_size=1, padding=0), nn.UpsamplingBilinear2d(scale_factor=2))

    def forward(self, x):
        for conv in self.convs:
            x = conv(x)
        x = x.permute(0, 3, 1, 2)
        res = self.residual[0](x)
        h, w = res.shape[-2:]
        res = resize(res, (2 * h, 2 * w), mode="bilinear", align_corners=True, channel_last=False)
        return (self.up(x) + res).flatten(2).transpose(1, 2)
