"""Upsampling stacks of the V2 depth head (counterpart of
unidepth_tpu/nn/upsample.py). Maps are NCHW here."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from unidepth_tpu_torch.nn.conv import Conv2d
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
