"""Fourier feature embeddings (counterpart of unidepth_tpu/ops/fourier.py)."""

from __future__ import annotations

import math

import numpy as np
import torch

from unidepth_tpu_torch.utils.built_once import built_once

__all__ = ["generate_fourier_features", "position_embedding_sine"]


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
    scales = _scales(num_bands, max_freq, use_log, x.dtype, x.device)
    # the arguments reach max_freq * pi * |x| (~28 rad in the tests, ~180 on
    # the V2 decoder's rays): sin and cos run in float64 and round once to
    # x's dtype, since torch's float32 sin on the CPU was seen 1.5e-4 off at
    # ~28 rad in some pytest worker processes (float64 stays within 1e-6 of
    # JAX's float32 sin)
    xb = (x[..., None] * scales).double()  # (..., D, num_bands)
    feats = [torch.sin(xb)]
    if use_cos:
        feats.append(torch.cos(xb))
    out = torch.cat(feats, dim=-1).to(x.dtype).reshape(*x.shape[:-1], -1)
    if cat_orig:
        out = torch.cat([out, x], dim=-1)
    return out


@built_once()
def _scales(num_bands: int, max_freq: int, use_log: bool, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The bands' frequencies times pi on ``device``."""
    if use_log:
        scales = 2.0 ** np.linspace(0.0, math.log2(max_freq), num=num_bands)
    else:
        scales = np.linspace(1.0, max_freq / 2, num=num_bands)
    return torch.as_tensor(scales * math.pi, dtype=dtype, device=device)


def position_embedding_sine(h: int, w: int, num_pos_feats: int = 64, normalize: bool = False, device=None) -> torch.Tensor:
    """DETR sine embedding of an unmasked (H, W) grid -> float32 (H, W,
    2 * num_pos_feats): the row embedding, then the column one, each with
    sin and cos interleaved, temperature 10000. Positions run 1..H and 1..W,
    optionally normalised to (0, 2 pi]. Evaluated in float64 and rounded
    once, as the JAX package does."""
    y = np.arange(1, h + 1, dtype=np.float64)
    x = np.arange(1, w + 1, dtype=np.float64)
    if normalize:
        y = y / (y[-1] + 1e-6) * 2.0 * math.pi
        x = x / (x[-1] + 1e-6) * 2.0 * math.pi
    dim_t = 10000.0 ** (2 * np.floor(np.arange(num_pos_feats) / 2) / num_pos_feats)

    def interleave(p):  # (L, F): sin of the even columns beside cos of the odd ones
        return np.stack([np.sin(p[:, 0::2]), np.cos(p[:, 1::2])], axis=2).reshape(p.shape[0], -1)

    pos_y = interleave(y[:, None] / dim_t)
    pos_x = interleave(x[:, None] / dim_t)
    out = np.concatenate(
        [np.broadcast_to(pos_y[:, None], (h, w, num_pos_feats)), np.broadcast_to(pos_x[None], (h, w, num_pos_feats))],
        axis=-1,
    )
    return torch.as_tensor(out, dtype=torch.float32, device=device)
