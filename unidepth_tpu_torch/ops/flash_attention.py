"""Flash attention: the CUDA kernels ``csrc/attention_wgmma.cu`` and
``csrc/attention.cu`` and their plain PyTorch version (counterpart of
unidepth_tpu/ops/flash_attention.py).

Three entry points; each kernel reads every tensor through a base pointer,
a batch stride and a row stride, with head h at column h * D:

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

Which body runs is fixed by dtype and head dim, never by a failure: K1, K3
and K4 in bf16 at D = 64 (every ViT preset, and the ViT-L/14 V2 decoder's
cross-attentions) launch the Hopper body (``attention_wgmma.cu``: wgmma for
both products, TMA loads through an mbarrier ring, 128 x 128 tiles, any
number of keys streamed through the online softmax). K3 in bf16 at D = 48
(the ViT-B/14 V2 decoder) and 32 (ViT-S/14) launches the same body: its
flat (BH, N, D) tensors are maps of one head, whose 64-channel rows TMA
fills past D with zeros and whose stores clip there. K1 and K4 read several
heads packed in one row, where a 64-channel box at D < 64 would reach into
the next head, so they take the Hopper body at D = 64 only (no ViT preset
has another encoder head dim). fp32 and the other head dims launch the
mma.sync body (``attention.cu``), which takes every multiple of 8 up to 128
(a head dim off that grid raises: 16-byte rows). Both are bound by
compute on the H100 (~61.5 GFLOP per K1 call at the ViT-L serving shape
against < 0.1 GB moved): they keep fp32 softmax statistics and the online
row max (exact for any logits, so the TPU's logit audit has no
counterpart), and never write the N x N scores (see the sources for the
designs).

A CPU tensor takes the plain version. A CUDA tensor launches a kernel, or
raises when it cannot: nothing falls back. ``launches`` on each wrapper
counts the kernel launches it made; ``hopper_launches`` counts those of the
Hopper body among them. Both count forward launches only. Each launch runs
in the host span ``unidepth.kernel.K1``, ``K3`` or ``K4``
(``utils/tracing.py``).

Gradients: each kernel route is a ``torch.autograd.Function`` whose forward
is the launch and whose backward (``_flash_attention_qkv_bwd``,
``_flash_attention_bwd``, ``_flash_attention_packed_bwd``) is the VJP of the
plain version recomputed from the saved inputs: the counterpart of the JAX
``custom_vjp``s (``_bwd_qkv``, ``_bwd``, ``_bwd_packed``), which take
``jax.vjp`` of the XLA formulation. It materialises the N x N weights in
fp32, as the JAX backward does; a flash backward kernel is a speed item,
not part of the port.
"""

from __future__ import annotations

import torch

from unidepth_tpu_torch.ops import _cuda
from unidepth_tpu_torch.utils import tracing

__all__ = [
    "flash_attention",
    "flash_attention_packed",
    "flash_attention_packed_plain",
    "flash_attention_plain",
    "flash_attention_qkv",
    "flash_attention_qkv_plain",
]

SUPPORTED_HEAD_DIMS = tuple(range(8, 129, 8))  # attention.cu: 16-byte rows, at most 128
PACKED_MAX_KEYS = 4096  # the TPU kernel's whole-K VMEM bound (_packed_supported)
HOPPER_ENTRY = "ud_attention_hopper_fwd"  # attention_wgmma.cu: bf16, head dim 64 (one head: 32, 48)
# the mangled name of the main path's instantiation, attn_fwd_wgmma<kExact, 1, 3, 64>
# (attention_wgmma.cuh), as ptxas reports it
HOPPER_KERNEL = "attn_fwd_wgmmaILi0ELi1ELi3ELi64EE"
HOPPER_HEAD_DIM = 64
HOPPER_ONE_HEAD_DIMS = (32, 48)  # the Hopper body's narrower rows, for a map of one head


def flash_attention_plain(q, k, v, scale: float):
    """softmax(scale * q k^T) v over the last two axes, scores and softmax in
    fp32 (float64 stays float64), the weights cast to v's dtype before the
    product (as the TPU kernel does)."""
    logits = torch.matmul(_cuda.wide(q), _cuda.wide(k).transpose(-1, -2)) * scale
    w = torch.softmax(logits, dim=-1)
    return torch.matmul(_cuda.wide(w.to(v.dtype)), _cuda.wide(v)).to(v.dtype)


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


def _entry(dtype: torch.dtype, d: int, other: str, heads: int | None = None) -> str:
    """The C entry K1, K3 or K4 launches: the Hopper body for bf16 at D = 64,
    or at D = 32 and 48 for a map of one head (``heads == 1``: K3 alone
    passes it, as the C entry requires), else ``other`` (the mma.sync /
    CUDA-core body of attention.cu)."""
    if dtype != torch.bfloat16:
        return other
    if d == HOPPER_HEAD_DIM or (heads == 1 and d in HOPPER_ONE_HEAD_DIMS):
        return HOPPER_ENTRY
    return other


def _launch(name, q, k_ptr, v_ptr, o, batch, heads, nq, nk, d, strides, scale, entry="ud_attention_fwd"):
    """strides: (q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs) in elements."""
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if entry == HOPPER_ENTRY and not 0 < scale < float("inf"):
        raise ValueError(f"{name}: the Hopper body takes its row max on the raw scores and needs scale > 0, got {scale}")
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
    return _qkv_kernel(qkv, num_heads, scale)


def _flash_attention_qkv_bwd(qkv, g, num_heads, scale):
    """K1's backward (the JAX ``_bwd_qkv``): the VJP of
    ``flash_attention_qkv_plain`` at ``qkv``. The softmax scale sits inside
    it, so the gradient of the q columns carries ``scale``."""
    return _cuda.plain_vjp(lambda t: flash_attention_qkv_plain(t, num_heads, scale), (qkv,), (True,), g)[0]


class _FlashAttentionQKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads, scale):
        ctx.save_for_backward(qkv)
        ctx.num_heads, ctx.scale = num_heads, scale
        with tracing.span("unidepth.kernel.K1"):
            return _qkv_launch(qkv, num_heads, scale)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        return _flash_attention_qkv_bwd(qkv, g, ctx.num_heads, ctx.scale), None, None


def _qkv_kernel(qkv, num_heads, scale):
    """K1's route, on whatever device ``qkv`` is (the CPU tests call it with
    the library stubbed to see the route): the launch under autograd."""
    return _FlashAttentionQKV.apply(qkv, num_heads, scale)


def _qkv_launch(qkv, num_heads, scale):
    """K1's launch."""
    if not qkv.is_contiguous():
        raise ValueError("flash_attention_qkv: qkv must be contiguous")
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    entry = _entry(qkv.dtype, d, "ud_attention_fwd")
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    step = c * qkv.element_size()
    _launch(
        "flash_attention_qkv", qkv, qkv.data_ptr() + step, qkv.data_ptr() + 2 * step, out,
        b, num_heads, n, n, d,
        (n * c3, c3, n * c3, c3, n * c3, c3, n * c, c), scale, entry,
    )
    flash_attention_qkv.launches += 1
    flash_attention_qkv.hopper_launches += entry == HOPPER_ENTRY
    return out


flash_attention_qkv.launches = 0
flash_attention_qkv.hopper_launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """q (BH, Nq, D), k and v (BH, Nk, D) -> (BH, Nq, D)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    _cuda.require_cuda("flash_attention", q, k, v)
    return _flash_kernel(q, k, v, scale)


def _flash_attention_bwd(q, k, v, g, scale, needs=(True, True, True)):
    """K3's backward (the JAX ``_bwd``): the VJP of ``flash_attention_plain``."""
    return _cuda.plain_vjp(lambda *t: flash_attention_plain(*t, scale), (q, k, v), needs, g)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        with tracing.span("unidepth.kernel.K3"):
            return _flash_launch(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        return (*_flash_attention_bwd(*ctx.saved_tensors, g, ctx.scale, ctx.needs_input_grad[:3]), None)


def _flash_kernel(q, k, v, scale):
    """K3's route, on whatever device the tensors are: the launch under
    autograd."""
    return _FlashAttention.apply(q, k, v, scale)


def _flash_launch(q, k, v, scale):
    """K3's launch: each (BH, N, D) tensor is a map with BH batches of one
    head, row stride D."""
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("flash_attention: q, k and v must share a dtype")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bh, nq, d = q.shape
    nk = k.shape[1]
    if k.shape != (bh, nk, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes {q.shape}, {k.shape}, {v.shape} do not match")
    entry = _entry(q.dtype, d, "ud_attention_fwd", heads=1)
    out = torch.empty_like(q)
    _launch(
        "flash_attention", q, k.data_ptr(), v.data_ptr(), out, bh, 1, nq, nk, d,
        (nq * d, d, nk * d, d, nk * d, d, nq * d, d), scale, entry,
    )
    flash_attention.launches += 1
    flash_attention.hopper_launches += entry == HOPPER_ENTRY
    return out


flash_attention.launches = 0
flash_attention.hopper_launches = 0


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
    return _packed_kernel(q, k, v, num_heads, scale)


def _flash_attention_packed_bwd(q, k, v, g, num_heads, scale, needs=(True, True, True)):
    """K4's backward (the JAX ``_bwd_packed``): the VJP of
    ``flash_attention_packed_plain``."""
    return _cuda.plain_vjp(lambda *t: flash_attention_packed_plain(*t, num_heads, scale), (q, k, v), needs, g)


class _FlashAttentionPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, num_heads, scale):
        ctx.save_for_backward(q, k, v)
        ctx.num_heads, ctx.scale = num_heads, scale
        with tracing.span("unidepth.kernel.K4"):
            return _packed_launch(q, k, v, num_heads, scale)

    @staticmethod
    def backward(ctx, g):
        grads = _flash_attention_packed_bwd(*ctx.saved_tensors, g, ctx.num_heads, ctx.scale, ctx.needs_input_grad[:3])
        return (*grads, None, None)


def _packed_kernel(q, k, v, num_heads, scale):
    """K4's route in the packed regime, on whatever device the tensors are:
    the launch under autograd."""
    return _FlashAttentionPacked.apply(q, k, v, num_heads, scale)


def _packed_launch(q, k, v, num_heads, scale):
    """K4's launch in the packed regime."""
    b, nq, c = q.shape
    nk, d = k.shape[1], c // num_heads
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("flash_attention_packed: q, k and v must share a dtype")
    if any(t.stride(2) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention_packed: the channel axis must have stride 1")
    strides = (q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1), nq * c, c)
    if any(s % 8 for s in strides[0::2]):
        raise ValueError(f"flash_attention_packed: batch strides {strides[0::2]} must be multiples of 8")
    entry = _entry(q.dtype, d, "ud_attention_packed_fwd")
    out = torch.empty((b, nq, c), dtype=q.dtype, device=q.device)
    _launch(
        "flash_attention_packed", q, k.data_ptr(), v.data_ptr(), out, b, num_heads, nq, nk, d,
        strides, scale, entry,
    )
    flash_attention_packed.launches += 1
    flash_attention_packed.hopper_launches += entry == HOPPER_ENTRY
    return out


flash_attention_packed.launches = 0
flash_attention_packed.hopper_launches = 0
