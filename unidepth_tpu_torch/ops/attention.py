"""Scaled dot-product attention (counterpart of unidepth_tpu/ops/attention.py).

* ``sdpa``: plain einsum attention over (B, H, N, D) with an fp32 softmax.
* ``attention``: the dispatch, the rule of the JAX package. It takes the
  flash kernel (K3, ``ops.flash_attention.flash_attention``) when there is
  no bias, both sequences hold at least 1024 tokens, ``d <= 128`` and the
  tensors are off the CPU; otherwise plain ``sdpa``, as the JAX package
  uses XLA there (the camera head's 4-token attention, for one). A head dim
  the kernel does not take (it takes 16, 32, 64 and 128) raises there rather
  than running plain.
"""

from __future__ import annotations

import torch

from unidepth_tpu_torch.ops.flash_attention import flash_attention

__all__ = ["sdpa", "attention"]

FLASH_MIN_TOKENS = 1024


def sdpa(q, k, v, bias=None, scale: float | None = None):
    """Attention over ``(B, H, N, D)`` with fp32 scores and softmax."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w.to(v.dtype).float(), v.float()).to(v.dtype)


def attention(q, k, v, bias=None):
    """Dispatching attention over (B, H, N, D)."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    use_flash = (
        bias is None
        and min(nq, nk) >= FLASH_MIN_TOKENS
        and d <= 128
        and q.device.type != "cpu"
    )
    if not use_flash:
        return sdpa(q, k, v, bias=bias)
    out = flash_attention(
        q.reshape(b * h, nq, d), k.reshape(b * h, nk, d), v.reshape(b * h, nk, d), d**-0.5
    )
    return out.reshape(b, h, nq, d)
