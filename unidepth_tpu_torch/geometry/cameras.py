"""Pinhole camera (counterpart of ``Pinhole`` in unidepth_tpu/geometry/cameras.py).

A camera holds a ``(B, 4)`` float32 tensor of ``(fx, fy, cx, cy)``; ``crop``
and ``resize`` return new cameras and never modify the caller's tensor.
Rays are channel-last ``(B, H, W, 3)``. The other camera models and
``BatchCamera`` are not ported yet.
"""

from __future__ import annotations

import torch

from unidepth_tpu_torch.geometry.coords import coords_grid

__all__ = ["Pinhole"]


class Pinhole:
    """Perspective camera; params (fx, fy, cx, cy)."""

    def __init__(self, params: torch.Tensor):
        self.params = params

    @property
    def batch(self) -> int:
        return self.params.shape[0]

    @classmethod
    def from_K(cls, K: torch.Tensor) -> "Pinhole":
        """K: (3, 3) or (B, 3, 3) intrinsics matrix."""
        if K.ndim == 2:
            K = K[None]
        params = torch.stack([K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]], dim=-1)
        return cls(params.float())

    def expand(self, batch: int) -> "Pinhole":
        """Broadcast a one-camera batch to ``batch`` cameras."""
        return Pinhole(self.params.expand(batch, self.params.shape[1]))

    def crop(self, left, top) -> "Pinhole":
        """Shift the principal point; negative values express padding."""
        delta = torch.zeros_like(self.params)
        delta[..., 2] = -left
        delta[..., 3] = -top
        return Pinhole(self.params + delta)

    def resize(self, factor: float) -> "Pinhole":
        return Pinhole(self.params * factor)

    def unproject(self, uv: torch.Tensor) -> torch.Tensor:
        fx, fy, cx, cy = (self.params[:, None, None, i] for i in range(4))
        x = (uv[..., 0] - cx) / fx
        y = (uv[..., 1] - cy) / fy
        return torch.stack([x, y, torch.ones_like(x)], dim=-1)

    def get_rays(self, h: int, w: int, eps: float = 1e-4) -> torch.Tensor:
        """Unit ray directions (B, H, W, 3)."""
        uv = coords_grid(h, w, device=self.params.device).expand(self.batch, h, w, 2)
        rays = self.unproject(uv)
        return rays / torch.linalg.norm(rays, dim=-1, keepdim=True).clamp_min(eps)
