"""Positional encodings (counterpart of unidepth_tpu/nn/positional.py): the
learned sinusoidal embedding and the 2-D vision RoPE (axial rotary
embedding, its cos/sin tables precomputed a position). The DETR sine
embedding both decoders use is ``ops/fourier.py``'s. No model builds these;
they keep the JAX package's inventory whole."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

__all__ = ["LearnedSinusoidalPosEmb", "rope_2d_tables", "apply_rope"]


class LearnedSinusoidalPosEmb(nn.Module):
    """sin and cos of learned frequencies: ``weights`` (dim / 2,), drawn
    from a unit normal."""

    def __init__(self, dim: int):
        super().__init__()
        if dim % 2:
            raise ValueError(f"LearnedSinusoidalPosEmb: dim {dim} must be even")
        self.weights = nn.Parameter(torch.randn(dim // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B,) scalar positions -> (B, dim + 1): x, sin, cos."""
        f = x[:, None] * self.weights[None, :] * 2.0 * math.pi
        return torch.cat([x[:, None], torch.sin(f), torch.cos(f)], dim=-1)


def rope_2d_tables(h: int, w: int, dim: int, theta: float = 10000.0):
    """Axial 2-D rotary tables: half the head dim rotates with the row
    coordinate, half with the column. Computed in float64, returned as
    float32 (cos, sin) of shape (h * w, dim)."""
    half = dim // 2
    freqs = 1.0 / (theta ** (np.arange(0, half, 2, dtype=np.float64) / half))
    fy = np.repeat(np.einsum("i,j->ij", np.arange(h, dtype=np.float64), freqs), 2, axis=-1)  # (h, half)
    fx = np.repeat(np.einsum("i,j->ij", np.arange(w, dtype=np.float64), freqs), 2, axis=-1)  # (w, half)
    full = np.concatenate(
        [np.broadcast_to(fy[:, None, :], (h, w, half)), np.broadcast_to(fx[None, :, :], (h, w, half))], axis=-1
    ).reshape(h * w, dim)
    return torch.from_numpy(np.cos(full).astype(np.float32)), torch.from_numpy(np.sin(full).astype(np.float32))


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...) over the last axis."""
    return torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1).reshape(x.shape)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., N, D) rotated by the tables (N, D)."""
    return x * cos + _rotate_half(x) * sin
