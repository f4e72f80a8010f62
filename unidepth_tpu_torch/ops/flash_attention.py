"""Flash attention: the CUDA kernel ``csrc/attention.cu`` and its plain
PyTorch version (counterpart of unidepth_tpu/ops/flash_attention.py).

Three entry points share the one kernel, which reads each tensor through a
base pointer, a batch stride and a row stride, with head h at column h * D:

* ``flash_attention_qkv`` (kernel K1) replaces the TPU kernel
  ``flash_attention_qkv`` (``_flash_fwd_qkv`` / ``_packed_kernel``): the ViT
  self-attention reading q, k and v straight from the fused (B, N, 3C) QKV
  projection and writing (B, N, C).
* ``flash_attention`` (kernel K3) replaces the TPU kernel ``flash_attention``
  (``_flash_fwd`` / ``_flash_kernel``) on flat (BH, N, D) tensors; the
  decoder's cross-attentions reach it through ``ops.attention.attention``.
* ``flash_attention_packed`` (kernel K4) replaces the TPU kernel
  ``flash_attention_packed`` (``_flash_fwd_packed`` / ``_packed_kernel``):
  three (B, N, H*D) tensors, q unscaled. The int8 ViT block hands it the
  channel slices of its (B, N, 3C) projection as strided views, which the
  kernel reads in place. Shapes outside ``packed_supported`` go to K3 by a
  head split and merge, as in the JAX package.

The kernel is bound by compute on the H100 (~61.5 GFLOP per K1 call at the
ViT-L serving shape against < 0.1 GB moved): it runs both products on the
tensor cores in bf16 with fp32 softmax statistics, keeps the online row max
(exact for any logits, so the TPU's logit audit has no counterpart), and
never writes the N x N scores (see the source for the design).

A CPU tensor takes the plain version. A CUDA tensor launches the kernel, or
raises when it cannot: nothing falls back. ``launches`` on each wrapper
counts the kernel launches it made.
"""

from __future__ import annotations

import torch

from unidepth_tpu_torch.ops import _cuda

__all__ = [
    "flash_attention",
    "flash_attention_packed",
    "flash_attention_packed_plain",
    "flash_attention_plain",
    "flash_attention_qkv",
    "flash_attention_qkv_plain",
]

SUPPORTED_HEAD_DIMS = (8, 16, 32, 64, 128)
PACKED_MAX_KEYS = 4096  # the TPU kernel's whole-K VMEM bound (_packed_supported)


def flash_attention_plain(q, k, v, scale: float):
    """softmax(scale * q k^T) v over the last two axes, scores and softmax in
    fp32, the weights cast to v's dtype before the product (as the TPU
    kernel does)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    w = torch.softmax(logits, dim=-1)
    return torch.matmul(w.to(v.dtype).float(), v.float()).to(v.dtype)


def flash_attention_qkv_plain(qkv, num_heads: int, scale: float):
    b, n, c3 = qkv.shape
    c = c3 // 3
    q, k, v = qkv.reshape(b, n, 3, num_heads, c // num_heads).permute(2, 0, 3, 1, 4)
    out = flash_attention_plain(q, k, v, scale)  # (B, H, N, D)
    return out.transpose(1, 2).reshape(b, n, c)


def flash_attention_packed_plain(q, k, v, num_heads: int, scale: float):
    """The head-packed attention on (B, N, H*D) tensors: fp32 scores and
    softmax, the weights cast to v's dtype before P V (``_xla_attention_packed``)."""
    b, nq, c = q.shape
    nk, d = k.shape[1], c // num_heads
    qh = q.reshape(b, nq, num_heads, d).transpose(1, 2)
    kh, vh = (t.reshape(b, nk, num_heads, d).transpose(1, 2) for t in (k, v))
    return flash_attention_plain(qh, kh, vh, scale).transpose(1, 2).reshape(b, nq, c)


def packed_supported(nk: int, c: int, num_heads: int) -> bool:
    """The JAX rule ``_packed_supported``: a head dim that tiles 128 lanes
    (with C a multiple of 128) or is 128, and at most 4096 keys padded to 128."""
    d = c // num_heads
    if d > 128 or (d < 128 and (128 % d != 0 or c % 128 != 0)):
        return False
    return -(-nk // 128) * 128 <= PACKED_MAX_KEYS


def _launch(name, q, k_ptr, v_ptr, o, batch, heads, nq, nk, d, strides, scale, entry="ud_attention_fwd"):
    """strides: (q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs) in elements."""
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if any(s % 8 for s in strides[1::2]):
        raise ValueError(f"{name}: row strides {strides[1::2]} must be multiples of 8")
    # the kernel loads rows with 16-byte cp.async; a misaligned base pointer
    # would fault on the card and poison the CUDA context
    ptrs = (q.data_ptr(), k_ptr, v_ptr, o.data_ptr())
    if any(p % 16 for p in ptrs):
        raise ValueError(f"{name}: q, k, v and out must start on 16-byte boundaries, got {[p % 16 for p in ptrs]}")
    lib = _cuda.library()
    err = getattr(lib, entry)(
        q.data_ptr(), k_ptr, v_ptr, o.data_ptr(), batch, heads, nq, nk, d,
        *strides, float(scale), _cuda.DTYPE_CODES[q.dtype], _cuda.stream_handle(q),
    )
    _cuda.check(err, name)


def flash_attention_qkv(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """(B, N, 3C) fused QKV projection -> (B, N, C) attention output; q, k, v
    are the channel slices [0,C), [C,2C), [2C,3C), heads channel-major."""
    if qkv.device.type == "cpu":
        return flash_attention_qkv_plain(qkv, num_heads, scale)
    _cuda.require_cuda("flash_attention_qkv", qkv)
    if not qkv.is_contiguous():
        raise ValueError("flash_attention_qkv: qkv must be contiguous")
    b, n, c3 = qkv.shape
    c = c3 // 3
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    step = c * qkv.element_size()
    _launch(
        "flash_attention_qkv", qkv, qkv.data_ptr() + step, qkv.data_ptr() + 2 * step, out,
        b, num_heads, n, n, c // num_heads,
        (n * c3, c3, n * c3, c3, n * c3, c3, n * c, c), scale,
    )
    flash_attention_qkv.launches += 1
    return out


flash_attention_qkv.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """q (BH, Nq, D), k and v (BH, Nk, D) -> (BH, Nq, D)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    _cuda.require_cuda("flash_attention", q, k, v)
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("flash_attention: q, k and v must share a dtype")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bh, nq, d = q.shape
    nk = k.shape[1]
    if k.shape != (bh, nk, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes {q.shape}, {k.shape}, {v.shape} do not match")
    out = torch.empty_like(q)
    _launch(
        "flash_attention", q, k.data_ptr(), v.data_ptr(), out, bh, 1, nq, nk, d,
        (nq * d, d, nk * d, d, nk * d, d, nq * d, d), scale,
    )
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_packed(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, scale: float | None = None
) -> torch.Tensor:
    """q (B, Nq, H*D), k and v (B, Nk, H*D), heads channel-major; any batch
    and row strides with a unit channel stride -> (B, Nq, H*D). q arrives
    unscaled; ``scale`` defaults to D**-0.5."""
    b, nq, c = q.shape
    nk = k.shape[1]
    d = c // num_heads
    if scale is None:
        scale = d**-0.5
    if k.shape != (b, nk, c) or v.shape != k.shape:
        raise ValueError(f"flash_attention_packed: shapes {q.shape}, {k.shape}, {v.shape} do not match")
    if not packed_supported(nk, c, num_heads):
        # head split and merge around K3, as the JAX package routes it
        def heads(x):
            return x.reshape(b, x.shape[1], num_heads, d).transpose(1, 2).reshape(b * num_heads, x.shape[1], d)

        out = flash_attention(heads(q), heads(k), heads(v), scale)
        return out.reshape(b, num_heads, nq, d).transpose(1, 2).reshape(b, nq, c)
    if q.device.type == "cpu":
        return flash_attention_packed_plain(q, k, v, num_heads, scale)
    _cuda.require_cuda("flash_attention_packed", q, k, v)
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("flash_attention_packed: q, k and v must share a dtype")
    if any(t.stride(2) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention_packed: the channel axis must have stride 1")
    strides = (q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1), nq * c, c)
    if any(s % 8 for s in strides[0::2]):
        raise ValueError(f"flash_attention_packed: batch strides {strides[0::2]} must be multiples of 8")
    out = torch.empty((b, nq, c), dtype=q.dtype, device=q.device)
    _launch(
        "flash_attention_packed", q, k.data_ptr(), v.data_ptr(), out, b, num_heads, nq, nk, d,
        strides, scale, entry="ud_attention_packed_fwd",
    )
    flash_attention_packed.launches += 1
    return out


flash_attention_packed.launches = 0
