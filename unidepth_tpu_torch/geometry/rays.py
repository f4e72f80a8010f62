"""Ray generation and the spherical z-buffer back-projection (counterpart
of ``generate_rays`` and ``spherical_zbuffer_to_euclidean`` in
unidepth_tpu/geometry/rays.py; the rest of that module is not ported yet).
Channel-last."""

from __future__ import annotations

import torch

from unidepth_tpu_torch.geometry.coords import coords_grid

__all__ = ["generate_rays", "spherical_zbuffer_to_euclidean"]


def generate_rays(K: torch.Tensor, shape: tuple[int, int]):
    """K (B, 3, 3) -> unit rays (B, H*W, 3) through the pixel centres and
    their angles (B, H*W, 2): theta = atan2(x, z), phi = acos(y)."""
    h, w = shape
    uv = coords_grid(h, w, device=K.device).reshape(-1, 2)
    fx, fy, cx, cy = (K[:, i, j, None] for i, j in ((0, 0), (1, 1), (0, 2), (1, 2)))
    x = (uv[None, :, 0] - cx) / fx
    y = (uv[None, :, 1] - cy) / fy
    rays = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True).clamp_min(1e-12)
    theta = torch.atan2(rays[..., 0], rays[..., 2])
    phi = torch.acos(rays[..., 1].clamp(-1.0, 1.0))
    return rays, torch.stack([theta, phi], dim=-1)


def spherical_zbuffer_to_euclidean(spherical: torch.Tensor) -> torch.Tensor:
    """(theta, phi, z) -> (x, y, z), z the z-buffer depth."""
    theta, phi, z = spherical.unbind(-1)
    x = z * torch.tan(theta)
    y = z / torch.tan(phi) / torch.cos(theta)
    return torch.stack([x, y, z], dim=-1)
