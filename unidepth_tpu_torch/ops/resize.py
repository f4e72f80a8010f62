"""Image resizing (counterpart of unidepth_tpu/ops/resize.py).

The JAX package resizes through dense resampling matrices because that form
feeds the TPU's matrix unit; its weights reproduce
``torch.nn.functional.interpolate`` exactly, so here it is ``F.interpolate``
itself. Like the JAX version, the interpolation runs in float32 and the
result is cast back to the input's dtype.

The nearest modes are a gather at source indices computed in float64, as
the JAX package computes them (F.interpolate's float32 scale picks another
neighbour at some ties), in the input's dtype.

The other exception is the bicubic resize with explicit scale factors
(DINOv2's offset pos-embed resize in V1). There ``F.interpolate`` rounds
the source coordinates to float32, ~1e-5 off on a 37-wide grid of unit
values, and its float64 kernel runs one thread per output pixel over all
channels (7.06 ms a call on the H100 for ViT-L's 1024 channels). So that
path takes JAX's form: two float32 products with resampling matrices
computed in float64.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from unidepth_tpu_torch.utils.built_once import built_once

__all__ = ["resize", "flat_interpolate"]

NEAREST_MODES = ("nearest", "nearest-exact")


def _nearest_index(in_size: int, out_size: int, exact: bool) -> np.ndarray:
    """Source index of each output pixel, computed in float64 as the JAX
    package computes it: floor((o + 0.5) * in / out) for 'nearest-exact',
    floor(o * in / out) for 'nearest', clamped to the input. (F.interpolate
    rounds the scale to float32 and so picks the neighbour at some exact
    ties, e.g. 30 -> 29 rows.)"""
    src = np.floor((np.arange(out_size) + (0.5 if exact else 0.0)) * (in_size / out_size)).astype(np.int64)
    return np.clip(src, 0, in_size - 1)


def _bicubic_matrix(in_size: int, out_size: int, scale_factor: float) -> np.ndarray:
    """(out, in) float64 weights of torch's bicubic (A = -0.75, no
    antialias, align_corners=False) with an explicit ``scale_factor``: the
    source of output o at (o + 0.5) / scale_factor - 0.5, its four taps
    clamped to the border."""
    a = -0.75
    src = (np.arange(out_size) + 0.5) / scale_factor - 0.5
    base = np.floor(src)
    t = src - base
    w = np.zeros((out_size, in_size))
    for tap, dist in zip((-1, 0, 1, 2), (1 + t, t, 1 - t, 2 - t)):
        near = ((a + 2) * dist - (a + 3)) * dist * dist + 1
        far = ((a * dist - 5 * a) * dist + 8 * a) * dist - 4 * a
        idx = np.clip(base + tap, 0, in_size - 1).astype(np.int64)
        np.add.at(w, (np.arange(out_size), idx), np.where(dist <= 1, near, far))
    return w


@built_once()
def _on(table, *args, dtype: torch.dtype | None = None, device: torch.device) -> torch.Tensor:
    """``table(*args)`` on ``device``."""
    return torch.as_tensor(table(*args), dtype=dtype, device=device)


def resize(
    x: torch.Tensor,
    size: tuple[int, int],
    mode: str = "bilinear",
    align_corners: bool = False,
    antialias: bool = False,
    channel_last: bool = True,
    scale_factors: tuple[float, float] | None = None,
    nhwc: bool = False,
) -> torch.Tensor:
    """Resize ``(..., H, W, C)`` (``channel_last``) or ``(..., H, W)`` maps
    to ``size`` with ``F.interpolate`` semantics. Modes: 'bilinear' (with or
    without ``align_corners`` / ``antialias``), 'bicubic', and 'nearest' /
    'nearest-exact', which take neither flag.
    ``scale_factors`` (sh, sw), bicubic only: torch's explicit
    ``scale_factor`` semantics, the source grid at 1/scale; the output must
    come out at ``size``.
    ``nhwc`` (``channel_last=False``, bilinear, a (B, C, H, W) map): the
    result is cast back to the input's dtype NHWC in memory
    (``channels_last``), so ``.permute(0, 2, 3, 1)`` of it is a contiguous
    (B, H, W, C); the interpolation itself is unchanged."""
    out_h, out_w = int(size[0]), int(size[1])
    y = x.movedim(-1, -3) if channel_last else x
    in_h, in_w = y.shape[-2:]
    if nhwc and (channel_last or mode != "bilinear" or y.dim() != 4):
        raise ValueError("resize: nhwc takes a (B, C, H, W) map, channel_last=False, bilinear")
    if scale_factors is not None:
        if mode != "bicubic" or align_corners or antialias:
            raise ValueError("resize: scale_factors take plain bicubic only")
        if (int(in_h * scale_factors[0]), int(in_w * scale_factors[1])) != (out_h, out_w):
            raise ValueError(f"resize: scale factors {scale_factors} do not give {(out_h, out_w)} from {(in_h, in_w)}")
        wh, ww = (_on(_bicubic_matrix, n, m, f, dtype=torch.float32, device=x.device)
                  for n, m, f in ((in_h, out_h, scale_factors[0]), (in_w, out_w, scale_factors[1])))
        y = torch.einsum("oh,...hw,pw->...op", wh, y.float(), ww).to(x.dtype)
        return y.movedim(-3, -1) if channel_last else y
    layout = torch.channels_last if nhwc else torch.preserve_format
    if (in_h, in_w) == (out_h, out_w):
        return x.contiguous(memory_format=torch.channels_last) if nhwc else x
    if mode in NEAREST_MODES:
        if align_corners or antialias:
            raise ValueError(f"resize: mode {mode!r} takes neither align_corners nor antialias")
        exact = mode == "nearest-exact"
        ih, iw = (_on(_nearest_index, n, m, exact, device=x.device) for n, m in ((in_h, out_h), (in_w, out_w)))
        y = y.index_select(-2, ih).index_select(-1, iw)
        return y.movedim(-3, -1) if channel_last else y
    lead = y.shape[:-2]
    # every leading axis is independent: fold them into channels
    y = F.interpolate(
        y.reshape(1, -1, in_h, in_w).float(),
        size=(out_h, out_w),
        mode=mode,
        align_corners=align_corners,
        antialias=antialias,
    )
    # one pass casts and, for nhwc, transposes: faster on the card than interpolating NHWC
    y = y.reshape(*lead, out_h, out_w).to(x.dtype, memory_format=layout)
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
