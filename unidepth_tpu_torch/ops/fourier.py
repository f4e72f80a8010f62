"""Fourier feature embeddings (counterpart of unidepth_tpu/ops/fourier.py)."""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["generate_fourier_features"]


def generate_fourier_features(
    x: torch.Tensor,
    dim: int = 512,
    max_freq: int = 64,
    use_cos: bool = False,
    use_log: bool = False,
    cat_orig: bool = False,
) -> torch.Tensor:
    """Sin(/cos) features of ``x`` (..., D) -> (..., dim[(+D)])."""
    input_dim = x.shape[-1]
    num_bands = dim // (2 * input_dim) if use_cos else dim // input_dim
    if use_log:
        scales = 2.0 ** np.linspace(0.0, math.log2(max_freq), num=num_bands)
    else:
        scales = np.linspace(1.0, max_freq / 2, num=num_bands)
    scales = torch.as_tensor(scales * math.pi, dtype=x.dtype, device=x.device)
    xb = x[..., None] * scales  # (..., D, num_bands)
    feats = [torch.sin(xb)]
    if use_cos:
        feats.append(torch.cos(xb))
    out = torch.cat(feats, dim=-1).reshape(*x.shape[:-1], -1)
    if cat_orig:
        out = torch.cat([out, x], dim=-1)
    return out
