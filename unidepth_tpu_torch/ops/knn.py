"""Nearest-neighbour distances between padded point clouds (counterpart of
unidepth_tpu/ops/knn.py, plain PyTorch: the JAX version is ``jnp`` under
``lax.map``, not a Pallas kernel).

Queries run in chunks of 2048 so that memory stays at chunk x P2, and each
chunk's squared distances come from one product, ||x||^2 + ||y||^2 -
2 x.y^T in float32 (TF32 stays off for it, PyTorch's default), clamped at
0. Invalid reference points are +inf before the min; invalid queries get
distance 0. ``argmin`` takes the first of ties, as JAX's does.
"""

from __future__ import annotations

import torch

__all__ = ["chamfer_distance", "knn_gather", "knn_points", "knn_topk", "nn_distances"]

CHUNK = 2048


def _chunk_sq_dists(xc: torch.Tensor, y: torch.Tensor, y2: torch.Tensor, y_valid: torch.Tensor) -> torch.Tensor:
    """xc (C, D), y (P2, D), y2 (P2,) -> (C, P2) squared distances, +inf at
    the invalid references."""
    x2 = (xc * xc).sum(-1, keepdim=True)
    d2 = x2 + y2[None, :] - 2.0 * (xc @ y.T)
    return d2.masked_fill(~y_valid[None, :], float("inf"))


def _valid(valid, n: int, device) -> torch.Tensor:
    return torch.ones(n, dtype=torch.bool, device=device) if valid is None else valid.bool()


def nn_distances(x: torch.Tensor, y: torch.Tensor, x_valid=None, y_valid=None, chunk: int = CHUNK):
    """x (P1, D), y (P2, D) -> (squared distance (P1,), index (P1,)) of each
    query's nearest valid reference."""
    x, y = x.float(), y.float()
    y_valid = _valid(y_valid, y.shape[0], y.device)
    y2 = (y * y).sum(-1)
    d2s, idxs = [], []
    for xc in x.split(chunk):
        d2 = _chunk_sq_dists(xc, y, y2, y_valid)
        m, i = d2.min(dim=-1)
        d2s.append(m.clamp_min(0.0))
        idxs.append(i)
    d2, idx = torch.cat(d2s), torch.cat(idxs)
    if x_valid is not None:
        d2 = torch.where(x_valid.bool(), d2, 0.0)
    return d2, idx


def knn_topk(x: torch.Tensor, y: torch.Tensor, x_valid=None, y_valid=None, k: int = 1, chunk: int = CHUNK):
    """x (P1, D), y (P2, D) -> (squared distances (P1, K), indices (P1, K)),
    the K nearest ascending. Where fewer than K references are valid, the
    rest are 0 in both (PyTorch3D's ``knn_points`` padding)."""
    x, y = x.float(), y.float()
    y_valid = _valid(y_valid, y.shape[0], y.device)
    y2 = (y * y).sum(-1)
    d2s, idxs = [], []
    for xc in x.split(chunk):
        d2, i = _chunk_sq_dists(xc, y, y2, y_valid).topk(k, dim=-1, largest=False, sorted=True)
        found = d2 < float("inf")
        d2s.append(torch.where(found, d2.clamp_min(0.0), 0.0))
        idxs.append(torch.where(found, i, 0))
    d2, idx = torch.cat(d2s), torch.cat(idxs)
    if x_valid is not None:
        keep = x_valid.bool()[:, None]
        d2, idx = torch.where(keep, d2, 0.0), torch.where(keep, idx, 0)
    return d2, idx


def knn_points(x: torch.Tensor, y: torch.Tensor, x_valid=None, y_valid=None, k: int = 1):
    """Batched (B, P1, D) queries against (B, P2, D) references with
    validity masks -> (squared distances (B, P1, K), indices (B, P1, K)),
    ascending."""
    b = x.shape[0]
    xv = [None] * b if x_valid is None else x_valid
    yv = [None] * b if y_valid is None else y_valid
    if k == 1:
        res = [nn_distances(x[i], y[i], xv[i], yv[i]) for i in range(b)]
        return torch.stack([d for d, _ in res])[..., None], torch.stack([i for _, i in res])[..., None]
    res = [knn_topk(x[i], y[i], xv[i], yv[i], k=k) for i in range(b)]
    return torch.stack([d for d, _ in res]), torch.stack([i for _, i in res])


def knn_gather(y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """y (B, P2, D), idx (B, P1, K) -> the neighbours (B, P1, K, D)."""
    b, p1, k = idx.shape
    flat = idx.reshape(b, p1 * k, 1).expand(b, p1 * k, y.shape[-1])
    return torch.gather(y, 1, flat).reshape(b, p1, k, y.shape[-1])


def chamfer_distance(x: torch.Tensor, y: torch.Tensor, x_valid=None, y_valid=None):
    """The two directional squared distances of the symmetric Chamfer
    distance: (x -> nearest y, y -> nearest x)."""
    d_xy, _ = nn_distances(x, y, x_valid, y_valid)
    d_yx, _ = nn_distances(y, x, y_valid, x_valid)
    return d_xy, d_yx
