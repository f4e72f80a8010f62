"""ConvNeXt(-V2) encoder (counterpart of unidepth_tpu/models/backbones/convnext.py).

Channel-last (B, H, W, 3) images in; the timm layout of the reference
checkpoint (``stem.{0,1}``, ``stages.{s}.downsample.{0,1}``,
``stages.{s}.blocks.{j}.{conv_dw,norm,mlp.fc1,mlp.fc2,gamma}``, GRN as
``mlp.grn``). The 4x4/4 stem, the 2x2/2 downsample convs and the 7x7
depthwise convs are cuDNN convolutions on channels-last views; every
LayerNorm has eps 1e-6. Each block's LN -> pwconv1 -> exact GELU is kernel
K2 on the card where its shape gate holds (``nn.layers.ln_linear_gelu``):
every ConvNeXt-L stage, C = 192 / 384 / 768 / 1536, F = 4C.

It stacks as V1 consumes it (JAX ``stacking='max_cls'``, the only use in
the port): each stage's elementwise max over its blocks (a running max: no
block's output is kept), and the spatial-mean tokens of the last
``len(depths)`` blocks overall, in natural order. For ConvNeXt-L those are
stage 2's last block (C = 768) and stage 3's three (C = 1536): the tokens
are not all of one width.

Under autograd (training) each block runs under ``torch.utils.checkpoint``
(non-reentrant), the counterpart of the JAX ``nn.remat`` blocks: K2 launches
twice a block per micro-batch. ``forward(image, generator)`` with
``drop_path_rate > 0`` applies stochastic depth to each block's residual
branch at the JAX ramp ``linspace(0, rate, sum(depths))``: one per-sample
keep mask a block, drawn from ``generator`` before the block runs, so the
recompute sees the same draw.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from unidepth_tpu_torch.nn.layers import drop_path, layer_norm, ln_linear_gelu, uniform_rows

LAYER_SCALE_INIT = 1e-6


@dataclasses.dataclass(frozen=True)
class ConvNeXtConfig:
    depths: tuple[int, ...] = (3, 3, 27, 3)
    dims: tuple[int, ...] = (192, 384, 768, 1536)
    use_grn: bool = False  # ConvNeXt-V2
    drop_path_rate: float = 0.0  # stochastic depth at train time, a linear per-block ramp

    @property
    def token_dims(self) -> tuple[int, ...]:
        """The widths of the ``max_cls`` tokens: the last len(depths) blocks."""
        per_block = [dim for depth, dim in zip(self.depths, self.dims) for _ in range(depth)]
        return tuple(per_block[-len(self.depths):])


CONVNEXT_PRESETS = {
    "convnext_large": ConvNeXtConfig(),
    "convnext_large_pt": ConvNeXtConfig(),
    "convnextv2_large": ConvNeXtConfig(use_grn=True),
    "convnextv2_base": ConvNeXtConfig(dims=(128, 256, 512, 1024), use_grn=True),
    "convnextv2_huge": ConvNeXtConfig(dims=(352, 704, 1408, 2816), use_grn=True),
}


class GlobalResponseNorm(nn.Module):
    """ConvNeXt-V2 GRN over the spatial axes of (B, H, W, C)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        gx = torch.sqrt(x.square().sum(dim=(1, 2), keepdim=True) + 1e-12)
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        return self.weight * (x * nx) + self.bias + x


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, use_grn: bool):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.grn = GlobalResponseNorm(hidden) if use_grn else None
        self.fc2 = nn.Linear(hidden, dim)


class ConvNeXtBlock(nn.Module):
    """dw 7x7 -> LN -> fc1 -> GELU [-> GRN] -> fc2 [-> layer scale], residual."""

    def __init__(self, dim: int, use_grn: bool = False):
        super().__init__()
        self.use_kernels = True
        self.conv_dw = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim, 4 * dim, use_grn)
        self.gamma = None if use_grn else nn.Parameter(torch.full((dim,), LAYER_SCALE_INIT))

    def forward(self, x, keep_mask=None, keep: float = 1.0):
        """``keep_mask``: None, or (B,) bools, the stochastic-depth draw of
        the residual branch at keep probability ``keep``."""
        y = self.conv_dw(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        y = ln_linear_gelu(self.norm, self.mlp.fc1, y, self.use_kernels)
        if self.mlp.grn is not None:
            y = self.mlp.grn(y)
        y = self.mlp.fc2(y)
        if self.gamma is not None:
            y = y * self.gamma
        if keep_mask is not None:
            y = drop_path(y, keep_mask, keep)
        return x + y


class _Stage(nn.Module):
    def __init__(self, in_dim: int | None, dim: int, depth: int, use_grn: bool):
        super().__init__()
        self.downsample = None
        if in_dim is not None:  # LN, then a 2x2 stride-2 conv
            self.downsample = nn.Sequential(nn.LayerNorm(in_dim, eps=1e-6), nn.Conv2d(in_dim, dim, 2, stride=2))
        self.blocks = nn.ModuleList([ConvNeXtBlock(dim, use_grn) for _ in range(depth)])


class ConvNeXt(nn.Module):
    """ConvNeXt encoder returning per-stage (B, h, w, C) max-stacked
    features and the (B, 1, C) tokens of its last len(depths) blocks."""

    def __init__(self, cfg: ConvNeXtConfig):
        super().__init__()
        self.cfg = cfg
        self.stem = nn.Sequential(nn.Conv2d(3, cfg.dims[0], 4, stride=4), nn.LayerNorm(cfg.dims[0], eps=1e-6))
        self.stages = nn.ModuleList(
            [
                _Stage(cfg.dims[si - 1] if si else None, dim, depth, cfg.use_grn)
                for si, (depth, dim) in enumerate(zip(cfg.depths, cfg.dims))
            ]
        )

    def forward(self, image: torch.Tensor, generator: torch.Generator | None = None):
        """image: (B, H, W, 3). ``generator`` turns stochastic depth on
        (training) when the config's ``drop_path_rate`` is positive."""
        rates = iter(np.linspace(0.0, self.cfg.drop_path_rate, sum(self.cfg.depths)))
        use_dp = generator is not None and self.cfg.drop_path_rate > 0.0
        x = self.stem[0](image.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        x = layer_norm(self.stem[1], x)
        feats, tokens = [], []
        remaining = sum(self.cfg.depths)
        for stage in self.stages:
            if stage.downsample is not None:
                norm, conv = stage.downsample
                x = conv(layer_norm(norm, x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            stage_max = None
            for block in stage.blocks:
                rate = float(next(rates))
                keep, mask = 1.0 - rate, None
                if use_dp and rate > 0.0:
                    mask = (uniform_rows(generator, (), x.shape[0]) < keep).to(x.device)
                if torch.is_grad_enabled():
                    # the mask is an input, so no RNG state needs restoring
                    x = checkpoint(block, x, mask, keep, use_reentrant=False, preserve_rng_state=False)
                else:
                    x = block(x, mask, keep)
                stage_max = x if stage_max is None else torch.maximum(stage_max, x)
                remaining -= 1
                if remaining < len(self.cfg.depths):
                    tokens.append(x.mean(dim=(1, 2))[:, None])
            feats.append(stage_max)
        return feats, tokens
