"""Fused LayerNorm -> dense -> GELU: the CUDA kernel ``csrc/ln_dense.cu``
(kernel K2) and its plain PyTorch version (counterpart of
unidepth_tpu/ops/fused_block.py).

``ln_dense`` replaces the TPU kernel ``ln_dense`` (``_ln_dense_fwd`` /
``_ln_dense_kernel``): the ViT block's LN2 -> fc1 -> exact GELU. On the H100
it is bound by compute (~92 GFLOP per call at the ViT-L serving shape
against ~120 MB moved), so the kernel runs the GEMM on the tensor cores and
normalises x in fp32 into shared memory right before the tensor cores read
it: the normalised activation never reaches device memory. The GELU is the
exact erf form (CUDA has ``erff``; the TPU kernel's A&S approximation is not
carried over).

A CPU tensor takes the plain version. A CUDA tensor launches the kernel or
raises: nothing falls back. ``ln_dense.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from unidepth_tpu_torch.ops import _cuda

__all__ = ["ln_dense", "ln_dense_plain"]

_ACTIVATIONS = (None, "gelu")


def ln_dense_plain(x, weight, bias, gamma, beta, eps: float, activation: str | None = None):
    """``act(LayerNorm(x; gamma, beta, eps) @ weight.T + bias)``: LN in fp32,
    cast to the weight's dtype for the product, bias and GELU in fp32, the
    result in x's dtype."""
    y = F.layer_norm(x.float(), x.shape[-1:], gamma.float(), beta.float(), eps)
    out = F.linear(y.to(weight.dtype), weight).float() + bias.float()
    if activation == "gelu":
        out = F.gelu(out)
    return out.to(x.dtype)


def ln_dense(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    eps: float,
    activation: str | None = None,
) -> torch.Tensor:
    """x (..., C); weight (F, C) in nn.Linear layout; bias (F,); gamma/beta
    (C,) -> (..., F) in x's dtype. ``activation``: None or 'gelu' (exact)."""
    if activation not in _ACTIVATIONS:
        raise ValueError(f"ln_dense: activation {activation!r} not in {_ACTIVATIONS}")
    if x.device.type == "cpu":
        return ln_dense_plain(x, weight, bias, gamma, beta, eps, activation)
    c = x.shape[-1]
    f = weight.shape[0]
    if weight.shape != (f, c) or c % 32 or f % 128:
        raise ValueError(f"ln_dense: needs C % 32 == 0 and F % 128 == 0, got x {x.shape}, weight {weight.shape}")
    if weight.dtype != x.dtype:
        raise ValueError(f"ln_dense: x {x.dtype} and weight {weight.dtype} differ")
    xm = x.reshape(-1, c).contiguous()
    w = weight.contiguous()
    b32, g32, bt32 = (t.float().contiguous() for t in (bias, gamma, beta))
    _cuda.require_cuda("ln_dense", xm, w, b32, g32, bt32)
    out = torch.empty((xm.shape[0], f), dtype=x.dtype, device=x.device)
    err = _cuda.library().ud_ln_dense_fwd(
        xm.data_ptr(), w.data_ptr(), b32.data_ptr(), g32.data_ptr(), bt32.data_ptr(),
        out.data_ptr(), xm.shape[0], c, f, float(eps), int(activation == "gelu"),
        _cuda.DTYPE_CODES[x.dtype], _cuda.stream_handle(x),
    )
    _cuda.check(err, "ln_dense")
    ln_dense.launches += 1
    return out.reshape(*x.shape[:-1], f)


ln_dense.launches = 0
