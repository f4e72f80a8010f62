"""Nystrom (landmark) attention (counterpart of unidepth_tpu/nn/nystrom.py).

The V1 depth head's self-attention at 1/8 and 1/4 scale: 128 landmarks are
segment means of q and k, and the softmax kernel is approximated as
K1 pinv(K2) (K3 v), the pseudo-inverse by 6 Newton-Schulz steps. JAX
computes it with XLA, so here it is plain PyTorch with JAX's dtypes: the
logits in fp32, the three softmax kernels cast to v's dtype, the
pseudo-inverse and the products in that dtype.
"""

from __future__ import annotations

import torch

from unidepth_tpu_torch.nn.layers import AttentionBlock
from unidepth_tpu_torch.ops.attention import sdpa

__all__ = ["NystromBlock", "nystrom_attention"]

NUM_LANDMARKS = 128  # the reference's xformers NystromAttention setting


def _iterative_pinv(mat: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Newton-Schulz pseudo-inverse of a softmax kernel, the xformers
    defaults: Z0 = K^T / max(column sum of K), then 6 steps."""
    col = mat.sum(dim=-2).amax(dim=-1)
    z = mat.transpose(-1, -2) / col[..., None, None]
    eye = torch.eye(mat.shape[-1], dtype=mat.dtype, device=mat.device)
    for _ in range(iters):
        kz = mat @ z
        z = 0.25 * z @ (13.0 * eye - kz @ (15.0 * eye - kz @ (7.0 * eye - kz)))
    return z


def _landmark_pool(x: torch.Tensor, m: int) -> torch.Tensor:
    """Segment means over the token axis of (B, H, N, D). For N not divisible
    by ``m`` the xformers AvgPool split: the first m - N % m landmarks
    average N // m tokens, the other N % m average N // m + 1."""
    b, h, n, d = x.shape
    seg, r = divmod(n, m)
    if r == 0:
        return x.reshape(b, h, m, seg, d).mean(dim=3)
    split = (m - r) * seg
    head = x[:, :, :split].reshape(b, h, m - r, seg, d).mean(dim=3)
    tail = x[:, :, split:].reshape(b, h, r, seg + 1, d).mean(dim=3)
    return torch.cat([head, tail], dim=2)


def nystrom_attention(q, k, v) -> torch.Tensor:
    """q, k, v: (B, H, N, D); exact attention when N <= the landmarks."""
    n, d = q.shape[-2:]
    if n <= NUM_LANDMARKS:
        return sdpa(q, k, v)
    scale = d**-0.5
    q_l = _landmark_pool(q, NUM_LANDMARKS)
    k_l = _landmark_pool(k, NUM_LANDMARKS)

    def soft(a, b):
        logits = torch.einsum("bhnd,bhmd->bhnm", a.float(), b.float()) * scale
        return torch.softmax(logits, dim=-1).to(v.dtype)

    k1, k2, k3 = soft(q, k_l), soft(q_l, k_l), soft(q_l, k)
    return k1 @ (_iterative_pinv(k2) @ (k3 @ v))


class NystromBlock(AttentionBlock):
    """AttentionBlock with landmark attention (the V1 self-attention use:
    ``pos_embed`` on q only)."""

    def _attend(self, q, k, v):
        return nystrom_attention(q, k, v)
