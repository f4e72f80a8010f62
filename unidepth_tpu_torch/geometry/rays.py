"""Ray generation, spherical <-> euclidean conversions, point projection
and the mask morphology of the evaluation (counterpart of
unidepth_tpu/geometry/rays.py). Channel-last."""

from __future__ import annotations

import torch

from unidepth_tpu_torch.geometry.coords import coords_grid

import torch.nn.functional as F

__all__ = ["generate_rays", "spherical_zbuffer_to_euclidean", "spherical_to_euclidean", "euclidean_to_spherical",
           "unproject_points", "project_points", "downsample_min", "dilate", "erode", "iou"]


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


def spherical_to_euclidean(spherical: torch.Tensor) -> torch.Tensor:
    """(theta, phi, r) -> (x, y, z), r the radial distance."""
    theta, phi, r = spherical.unbind(-1)
    return torch.stack([r * torch.sin(phi) * torch.sin(theta), r * torch.cos(phi),
                        r * torch.cos(theta) * torch.sin(phi)], dim=-1)


def euclidean_to_spherical(xyz: torch.Tensor) -> torch.Tensor:
    """(x, y, z) -> (theta, phi, r)."""
    x, y, z = xyz.unbind(-1)
    r = torch.sqrt(x * x + y * y + z * z)
    return torch.stack([torch.atan2(x / r, z / r), torch.acos((y / r).clamp(-1.0, 1.0)), r], dim=-1)


def unproject_points(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """depth (B, H, W, 1), K (B, 3, 3) -> points (B, H, W, 3). Integer pixel
    corners (no +0.5), as the reference has them here."""
    _, h, w, _ = depth.shape
    gy, gx = torch.meshgrid(torch.arange(h, dtype=depth.dtype, device=depth.device),
                            torch.arange(w, dtype=depth.dtype, device=depth.device), indexing="ij")
    fx, fy, cx, cy = (K[:, None, None, i, j] for i, j in ((0, 0), (1, 1), (0, 2), (1, 2)))
    x = (gx - cx) / fx
    y = (gy - cy) / fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1) * depth


def project_points(points_3d: torch.Tensor, K: torch.Tensor, image_shape: tuple[int, int]) -> torch.Tensor:
    """Mean-depth rendering of points (B, N, 3) through K (B, 3, 3) onto an
    (H, W) grid -> (B, H, W, 1): each point's z is added to the pixel its
    projection truncates to, then divided by the count there."""
    h, w = image_shape
    b = points_3d.shape[0]
    uvw = torch.einsum("bij,bnj->bni", K, points_3d)
    uv = (uvw[..., :2] / uvw[..., 2:3]).to(torch.int32)
    valid = (uv[..., 0] >= 0) & (uv[..., 0] < w) & (uv[..., 1] >= 0) & (uv[..., 1] < h)
    flat = (uv[..., 1].clamp(0, h - 1) * w + uv[..., 0].clamp(0, w - 1)).long()
    z = torch.where(valid, points_3d[..., 2], 0.0).float()
    depth = torch.zeros(b, h * w, device=points_3d.device).scatter_add_(1, flat, z)
    count = torch.zeros(b, h * w, device=points_3d.device).scatter_add_(1, flat, valid.float())
    return (depth / count.clamp_min(1.0)).reshape(b, h, w, 1)


def downsample_min(depth: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Min-pool downsample of sparse depth (B, H, W, 1), zeros invalid."""
    big = torch.where(depth == 0.0, 1e5, depth).permute(0, 3, 1, 2)
    pooled = -F.max_pool2d(-big, factor, factor).permute(0, 2, 3, 1)
    return torch.where(pooled > 1000.0, 0.0, pooled)


def _same_max_pool(m: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Stride-1 max pool of (B, H, W, 1) with XLA's "SAME" padding (the
    extra pad on the high side), padded with -inf."""
    lo = (kernel_size - 1) // 2
    hi = kernel_size - 1 - lo
    x = F.pad(m.permute(0, 3, 1, 2), (lo, hi, lo, hi), value=float("-inf"))
    return F.max_pool2d(x, kernel_size, 1).permute(0, 2, 3, 1)


def dilate(mask: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Binary dilation of (B, H, W, 1) by a max pool."""
    return (_same_max_pool(mask.float(), kernel_size) > 0).to(mask.dtype)


def erode(mask: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Binary erosion of (B, H, W, 1) by a min pool."""
    return (-_same_max_pool(-mask.float(), kernel_size) >= 1.0).to(mask.dtype)


def iou(mask1: torch.Tensor, mask2: torch.Tensor) -> torch.Tensor:
    a, b = mask1.bool(), mask2.bool()
    return (a & b).sum().float() / (a | b).sum().float().clamp_min(1.0)
