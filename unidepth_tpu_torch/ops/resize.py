"""Image resizing (counterpart of unidepth_tpu/ops/resize.py).

The JAX package resizes through dense resampling matrices because that form
feeds the TPU's matrix unit; its weights reproduce
``torch.nn.functional.interpolate`` exactly, so here it is ``F.interpolate``
itself. Like the JAX version, the interpolation runs in float32 and the
result is cast back to the input's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["resize", "flat_interpolate"]


def resize(
    x: torch.Tensor,
    size: tuple[int, int],
    mode: str = "bilinear",
    align_corners: bool = False,
    antialias: bool = False,
    channel_last: bool = True,
) -> torch.Tensor:
    """Resize ``(..., H, W, C)`` (``channel_last``) or ``(..., H, W)`` maps
    to ``size`` with ``F.interpolate`` semantics. Modes: 'bilinear' (with or
    without ``align_corners`` / ``antialias``) and 'bicubic'."""
    out_h, out_w = int(size[0]), int(size[1])
    y = x.movedim(-1, -3) if channel_last else x
    in_h, in_w = y.shape[-2:]
    if (in_h, in_w) == (out_h, out_w):
        return x
    lead = y.shape[:-2]
    # every leading axis is independent: fold them into channels
    y = F.interpolate(
        y.reshape(1, -1, in_h, in_w).float(),
        size=(out_h, out_w),
        mode=mode,
        align_corners=align_corners,
        antialias=antialias,
    )
    y = y.reshape(*lead, out_h, out_w).to(x.dtype)
    return y.movedim(-3, -1) if channel_last else y


def flat_interpolate(
    x: torch.Tensor,
    old: tuple[int, int],
    new: tuple[int, int],
    antialias: bool = True,
    mode: str = "bilinear",
) -> torch.Tensor:
    """Resize token grids ``(B, old_h*old_w, C) -> (B, new_h*new_w, C)``
    (align_corners=False)."""
    if tuple(old) == tuple(new):
        return x
    b, _, c = x.shape
    out = resize(x.reshape(b, old[0], old[1], c), new, mode=mode, antialias=antialias)
    return out.reshape(b, new[0] * new[1], c)
