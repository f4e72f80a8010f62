"""Packed-attention A/B variants: the CUDA kernels ``csrc/attention_ab.cu``
(kernels K6 and K7) and their plain PyTorch versions (counterpart of the
kernels of scripts/kernel_ab.py; the harness itself is
scripts_torch/kernel_ab.py).

``run_variant(variant, q, k, v, num_heads, scale)`` takes every name the
JAX ``run_variant`` takes, with the same meaning, on (B, N, H*D) tensors:

* ``base`` is the port's K4, ``flash_attention_packed``, as the JAX harness
  calls the JAX one;
* ``bd*`` names go to ``run_bd`` (kernel K7, replacing ``make_bd_kernel``);
* every other name is kernel K6 (replacing ``make_kernel``). q is pre-scaled
  and rounded to its dtype, ``(q * scale).to(q.dtype)``; masked keys take
  -1e30, not -inf; keys past N are zero rows. The names compute nine
  functions, and a name that differs from another only in its TPU layout
  (``tr*`` transposed scores, ``kt*`` an in-kernel relayout, ``oneblk`` one
  q block) shares that name's kernel:

  ====  =============================================  ===================================
  M1    row max; l = sum p32                           ``tr_max``; any other name
  M2    row max; l = sum bf16(p)                       ``bf16p``, ``lmxu``, ``bf16p+lmxu``
  M3    no max, exp(min(s, 80)); l = sum p32           ``nomax_guard``, ``tr``, ``kt_guard``, ``oneblk``,
                                                       ``tr*`` not listed elsewhere
  M4    no max, exp(min(s, 80)); l = sum bf16(p)       ``tr_lmxu``
  M5    shift 0, no clamp (inf past s ~ 88)            ``nomax``
  M6    p = s - rowmax, no exp; l <= 0, so the         ``noexp``
        divisor max(l, 1e-30) is 1e-30
  M7    p = bf16(s): no mask, no normalisation         ``gemmonly``, ``tr_gemmonly``
  M8    out = s[:, :D], all of Q K^T                   ``qk_only``, ``kt``
  M9    p = q[:, :1] over every padded key; out = p v  ``pv_only``
  ====  =============================================  ===================================

  Every family that normalises divides by max(l, 1e-30). The JAX harness's
  q block size (``_pick_blk_q_packed``) has no counterpart: the Hopper tile
  is the kernel's own.

``run_bd(q, k, v, num_heads, scale, blk_q=None, l_on_mxu=False)`` computes
what ``make_bd_kernel`` computes, head-pair attention with no row max,
exp(min(s, 80)) times the pad mask: M3, or M4 when ``l_on_mxu``. Its domain is
the JAX one, head dim 64 and an even head count; anything else raises
``ValueError`` (JAX raises ``TypeError`` in a reshape). ``blk_q`` is a tile
hint and changes nothing.

The card path is bf16 on the tensor cores, the dtype the harness studies:
K6 takes head dim 32 or 64, K7 64, and fp32 I/O on a CUDA tensor raises
``ValueError``. A CPU tensor (either dtype) takes the plain version. A CUDA
tensor launches the kernel or raises: nothing falls back. ``run_variant``
and ``run_bd`` count their kernel launches in ``launches``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from unidepth_tpu_torch.ops import _cuda
from unidepth_tpu_torch.ops.flash_attention import flash_attention_packed, flash_attention_packed_plain

__all__ = ["attention_ab_plain", "family", "run_bd", "run_variant", "run_variant_plain"]

FAMILY_CODES = {f"M{i}": i for i in range(1, 10)}
AB_HEAD_DIMS = (32, 64)
MASKED = -1e30  # the JAX harness's _NEG_INF


def family(variant: str) -> str:
    """The function (M1-M9) that a K6 variant name computes, as the
    branches of the JAX ``make_kernel`` and ``run_variant`` select it."""
    if variant == "base" or variant.startswith("bd"):
        raise ValueError(f"{variant!r} is not a K6 variant (base is K4, bd* is K7)")
    if variant == "oneblk":
        variant = "nomax_guard"
    if variant in ("qk_only", "kt"):
        return "M8"
    if variant == "pv_only":
        return "M9"
    if variant in ("gemmonly", "tr_gemmonly"):
        return "M7"
    if variant.startswith("tr"):
        return {"tr_max": "M1", "tr_lmxu": "M4"}.get(variant, "M3")
    if variant in ("nomax_guard", "kt_guard"):
        return "M3"
    if variant == "nomax":
        return "M5"
    if variant == "noexp":
        return "M6"
    if variant in ("bf16p", "lmxu", "bf16p+lmxu"):
        return "M2"
    return "M1"


def attention_ab_plain(fam: str, qs, k, v, num_heads: int):
    """Family ``fam`` on pre-scaled q, keys zero-padded to a multiple of 128
    as the harness pads them; products and sums in fp32, p cast to v's dtype
    before P V."""
    b, nq, c = qs.shape
    nk = k.shape[1]
    d = c // num_heads
    n_pad = -(-nk // 128) * 128
    dt = v.dtype

    def heads(x):
        return x.reshape(b, x.shape[1], num_heads, d).transpose(1, 2).float()

    qh = heads(qs)
    kh, vh = (heads(F.pad(t, (0, 0, 0, n_pad - nk))) for t in (k, v))
    if fam == "M9":
        out = qh[..., :1].expand(b, num_heads, nq, n_pad).to(dt).float() @ vh
    else:
        s = qh @ kh.transpose(-1, -2)
        if fam == "M8":
            out = s[..., :d]
        elif fam == "M7":
            out = s.to(dt).float() @ vh
        else:
            if fam in ("M3", "M4"):
                s = s.clamp(max=80.0)
            s = torch.where(torch.arange(n_pad, device=s.device) < nk, s, MASKED)
            m = s.amax(-1, keepdim=True) if fam in ("M1", "M2", "M6") else 0.0
            p32 = s - m if fam == "M6" else torch.exp(s - m)
            p = p32.to(dt).float()
            l = (p if fam in ("M2", "M4") else p32).sum(-1, keepdim=True)
            out = (p @ vh) / l.clamp(min=1e-30)
    return out.transpose(1, 2).reshape(b, nq, c).to(dt)


def _prescale(q, scale):
    """``(q * scale).astype(q.dtype)`` as the harness: one elementwise pass
    that multiplies in fp32 and rounds once to q's dtype."""
    return (q * scale).to(q.dtype)


def _checked(name, qs, k, v):
    """Validate what the CUDA entries take: bf16, one device, matching
    (B, N, C) shapes; returns contiguous q, k, v and an empty output."""
    _cuda.require_cuda(name, qs, k, v)
    if not (qs.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"{name}: the card path takes bf16 q, k and v, got {qs.dtype}, {k.dtype}, {v.dtype}")
    b, _, c = qs.shape
    if k.shape != (b, k.shape[1], c) or v.shape != k.shape:
        raise ValueError(f"{name}: shapes {tuple(qs.shape)}, {tuple(k.shape)}, {tuple(v.shape)} do not match")
    qs, k, v = qs.contiguous(), k.contiguous(), v.contiguous()
    return qs, k, v, torch.empty_like(qs)


def _attention_ab(fam: str, qs, k, v, num_heads: int):
    if qs.device.type == "cpu":
        return attention_ab_plain(fam, qs, k, v, num_heads)
    b, nq, c = qs.shape
    d = c // num_heads
    if d not in AB_HEAD_DIMS or d * num_heads != c:
        raise ValueError(f"run_variant: head dim {c}/{num_heads} not in {AB_HEAD_DIMS} on the card")
    qs, k, v, out = _checked("run_variant", qs, k, v)
    err = _cuda.library().ud_attention_ab_fwd(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, num_heads, nq, k.shape[1], d,
        FAMILY_CODES[fam], _cuda.stream_handle(qs),
    )
    _cuda.check(err, f"run_variant ({fam})")
    run_variant.launches += 1
    return out


def _bd_family(q, num_heads: int, l_on_mxu: bool) -> str:
    c = q.shape[-1]
    if num_heads % 2 or c != 64 * num_heads:
        raise ValueError(f"run_bd: head pairs of 64 only (C={c}, heads={num_heads})")
    return "M4" if l_on_mxu else "M3"


def run_bd(q, k, v, num_heads: int, scale: float, blk_q: int | None = None, l_on_mxu: bool = False):
    """Head-pair attention (K7): no row max, exp(min(s, 80)), keys past N
    masked, l from p32 or, with ``l_on_mxu``, from bf16 p. ``blk_q`` is the
    TPU's q block, a tile hint here."""
    fam = _bd_family(q, num_heads, l_on_mxu)
    qs = _prescale(q, scale)
    if qs.device.type == "cpu":
        return attention_ab_plain(fam, qs, k, v, num_heads)
    qs, k, v, out = _checked("run_bd", qs, k, v)
    err = _cuda.library().ud_attention_bd_fwd(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), q.shape[0], num_heads, q.shape[1],
        k.shape[1], int(l_on_mxu), _cuda.stream_handle(qs),
    )
    _cuda.check(err, "run_bd")
    run_bd.launches += 1
    return out


run_bd.launches = 0


def _bd_args(variant: str):
    blk = None
    if "352" in variant:
        blk = 352
    if "176" in variant:
        blk = 176
    return blk, "lmxu" in variant


def run_variant(variant: str, q, k, v, num_heads: int, scale: float):
    """The harness variant ``variant`` on (B, N, H*D) q, k, v (see the module
    docstring for the names)."""
    if variant == "base":
        return flash_attention_packed(q, k, v, num_heads, scale)
    if variant.startswith("bd"):
        blk, l_on_mxu = _bd_args(variant)
        return run_bd(q, k, v, num_heads, scale, blk_q=blk, l_on_mxu=l_on_mxu)
    return _attention_ab(family(variant), _prescale(q, scale), k, v, num_heads)


run_variant.launches = 0


def run_variant_plain(variant: str, q, k, v, num_heads: int, scale: float):
    """``run_variant`` through the plain versions on any device: what the
    kernels are held against."""
    if variant == "base":
        return flash_attention_packed_plain(q, k, v, num_heads, scale)
    if variant.startswith("bd"):
        fam = _bd_family(q, num_heads, _bd_args(variant)[1])
    else:
        fam = family(variant)
    return attention_ab_plain(fam, _prescale(q, scale), k, v, num_heads)
