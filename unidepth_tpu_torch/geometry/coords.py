"""Pixel coordinate grids (counterpart of unidepth_tpu/geometry/coords.py)."""

from __future__ import annotations

import torch

__all__ = ["coords_grid", "normalize_coords"]


def coords_grid(h: int, w: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """``(H, W, 2)`` grid of pixel-centre coordinates ``(x, y)``: centres sit
    at +0.5, so x runs over [0.5, W - 0.5] and y over [0.5, H - 0.5]."""
    xs = torch.arange(w, device=device, dtype=dtype) + 0.5
    ys = torch.arange(h, device=device, dtype=dtype) + 0.5
    return torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)], dim=-1)


def normalize_coords(coords: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Pixel coordinates ``(..., 2)`` (x, y) mapped to [-1, 1]: less the
    image's centre ((w - 1) / 2, (h - 1) / 2) in the coordinates' dtype,
    over it."""
    c = torch.tensor([(w - 1) / 2.0, (h - 1) / 2.0], dtype=coords.dtype, device=coords.device)
    return (coords - c) / c
