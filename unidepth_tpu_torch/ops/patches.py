"""Patch extraction and bilinear sampling (counterpart of
unidepth_tpu/ops/patches.py), plain PyTorch: XLA lowered the JAX versions
on its own, so neither is a kernel. Both are channel-last and
differentiable with respect to the sampled tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["extract_patches", "bilinear_sample"]


def extract_patches(x: torch.Tensor, centers: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """x (B, H, W, C); centers (B, N, 2) integer (y, x) window centres ->
    (B, N, kh, kw, C). Windows are cut from the zero-padded image, so what
    lies outside reads 0; a start past the padded edge is clamped, as
    ``lax.dynamic_slice`` clamps it."""
    kh, kw = size
    b, h, w, _ = x.shape
    ph, pw = kh // 2, kw // 2
    xp = F.pad(x, (0, 0, pw, pw, ph, ph))
    # a centre indexes the padded image's window start: +pad - pad
    y0 = centers[..., 0].long().clamp(0, h + 2 * ph - kh)
    x0 = centers[..., 1].long().clamp(0, w + 2 * pw - kw)
    rows = y0[..., :, None] + torch.arange(kh, device=x.device)  # (B, N, kh)
    cols = x0[..., :, None] + torch.arange(kw, device=x.device)  # (B, N, kw)
    bi = torch.arange(b, device=x.device)[:, None, None, None]
    return xp[bi, rows[..., :, None], cols[..., None, :]]


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor, zero_pad: bool = True) -> torch.Tensor:
    """img (B, H, W, C); coords (B, Ho, Wo, 2) as (x, y) pixel-centre
    positions (0.5 is the first pixel's centre) -> (B, Ho, Wo, C). With
    ``zero_pad`` a tap outside the image reads 0, else the border."""
    b, h, w, _ = img.shape
    x = coords[..., 0] - 0.5
    y = coords[..., 1] - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    dx, dy = (x - x0)[..., None], (y - y0)[..., None]
    bi = torch.arange(b, device=img.device).view(b, *(1,) * (coords.ndim - 2))

    def gather(iy, ix):
        vals = img[bi, iy.clamp(0, h - 1).long(), ix.clamp(0, w - 1).long()]
        if zero_pad:
            inside = (iy >= 0) & (iy <= h - 1) & (ix >= 0) & (ix <= w - 1)
            vals = vals * inside[..., None].to(img.dtype)
        return vals

    v00, v01 = gather(y0, x0), gather(y0, x0 + 1)
    v10, v11 = gather(y0 + 1, x0), gather(y0 + 1, x0 + 1)
    return v00 * (1 - dx) * (1 - dy) + v01 * dx * (1 - dy) + v10 * (1 - dx) * dy + v11 * dx * dy
