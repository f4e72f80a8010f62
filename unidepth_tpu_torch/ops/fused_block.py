"""Fused LayerNorm -> dense -> GELU: the CUDA kernels
``csrc/ln_dense_wgmma.cu`` and ``csrc/ln_dense.cu`` (kernel K2) and their
plain PyTorch version (counterpart of unidepth_tpu/ops/fused_block.py).

``ln_dense`` replaces the TPU kernel ``ln_dense`` (``_ln_dense_fwd`` /
``_ln_dense_kernel``): the ViT block's LN2 -> fc1 -> exact GELU. On the H100
it is bound by compute (~92 GFLOP per call at the ViT-L serving shape
against ~120 MB moved), so the kernels run the GEMM on the tensor cores and
normalise x in fp32 right before the tensor cores read it: the normalised
activation never reaches device memory. The GELU is the exact erf form
(CUDA has ``erff``; the TPU kernel's A&S approximation is not carried over).

Which body runs is fixed by dtype and shape, never by a failure: bf16 with
C % 64 == 0, C <= 2048 and F % 256 == 0 (the ViT-L block, and ConvNeXt's
C = 4F widths) launches the Hopper body, two launches a call
(``ud_ln_row_stats``: each row's mean and rstd into an (M, 2) fp32 scratch;
``ud_ln_dense_hopper_fwd``: wgmma with the LN applied to the A operand in
registers, TMA through an mbarrier ring, a persistent grid; it reads bf16
bias, gamma and beta as they are). fp32 and the
other shapes launch ``ln_dense.cu`` (mma.sync for bf16, CUDA cores for
fp32), which needs C % 32 == 0 and F % 128 == 0.

A CPU tensor takes the plain version. A CUDA tensor launches a kernel or
raises: nothing falls back. ``ln_dense.launches`` counts calls that
launched a kernel (a Hopper call counts once), ``ln_dense.hopper_launches``
those that ran the Hopper body; both count forward launches only.

The kernel route is a ``torch.autograd.Function``: its backward,
``_ln_dense_bwd``, is the VJP of ``ln_dense_plain`` recomputed from the
saved inputs, the counterpart of the JAX ``custom_vjp`` ``_bwd``, which
takes ``jax.vjp`` of ``_xla_ln_dense``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from unidepth_tpu_torch.ops import _cuda

__all__ = ["ln_dense", "ln_dense_plain"]

_ACTIVATIONS = (None, "gelu")
HOPPER_MAX_C = 2048  # gamma and beta are staged beside the ring in shared memory


def ln_dense_plain(x, weight, bias, gamma, beta, eps: float, activation: str | None = None):
    """``act(LayerNorm(x; gamma, beta, eps) @ weight.T + bias)``: LN in fp32
    (float64 stays float64), cast to the weight's dtype for the product,
    bias and GELU in fp32, the result in x's dtype."""
    wide = _cuda.wide
    y = F.layer_norm(wide(x), x.shape[-1:], wide(gamma), wide(beta), eps)
    out = wide(F.linear(y.to(weight.dtype), weight)) + wide(bias)
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
    _cuda.require_cuda("ln_dense", x, weight, bias, gamma, beta)
    return _ln_dense_kernel(x, weight, bias, gamma, beta, eps, activation)


def _ln_dense_bwd(x, weight, bias, gamma, beta, g, eps, activation, needs=(True,) * 5):
    """K2's backward (the JAX ``_bwd``): the VJP of ``ln_dense_plain``."""
    fn = lambda *t: ln_dense_plain(*t, eps, activation)  # noqa: E731
    return _cuda.plain_vjp(fn, (x, weight, bias, gamma, beta), needs, g)


class _LnDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, gamma, beta, eps, activation):
        ctx.save_for_backward(x, weight, bias, gamma, beta)
        ctx.eps, ctx.activation = eps, activation
        return _ln_dense_launch(x, weight, bias, gamma, beta, eps, activation)

    @staticmethod
    def backward(ctx, g):
        grads = _ln_dense_bwd(*ctx.saved_tensors, g, ctx.eps, ctx.activation, ctx.needs_input_grad[:5])
        return (*grads, None, None)


def _ln_dense_kernel(x, weight, bias, gamma, beta, eps, activation):
    """K2's route, on whatever device the tensors are (the CPU tests call it
    with the library stubbed to see the route): the launches under
    autograd."""
    return _LnDense.apply(x, weight, bias, gamma, beta, eps, activation)


def _ln_dense_launch(x, weight, bias, gamma, beta, eps, activation):
    """K2's launches."""
    c = x.shape[-1]
    f = weight.shape[0]
    if weight.shape != (f, c):
        raise ValueError(f"ln_dense: weight {tuple(weight.shape)} is not (F, {c})")
    if weight.dtype != x.dtype:
        raise ValueError(f"ln_dense: x {x.dtype} and weight {weight.dtype} differ")
    hopper = x.dtype == torch.bfloat16 and c % 64 == 0 and c <= HOPPER_MAX_C and f % 256 == 0
    if not hopper and (c % 32 or f % 128):
        raise ValueError(f"ln_dense: needs C % 32 == 0 and F % 128 == 0, got x {tuple(x.shape)}, weight {tuple(weight.shape)}")
    xm = x.reshape(-1, c).contiguous()
    w = weight.contiguous()
    # the Hopper body reads bf16 parameters as they are (the model's case);
    # anything else crosses as fp32
    params_bf16 = hopper and bias.dtype == gamma.dtype == beta.dtype == torch.bfloat16
    params = [t.contiguous() if params_bf16 else t.float().contiguous() for t in (bias, gamma, beta)]
    # both bodies load x and W rows 16 bytes at a time (TMA or cp.async): a
    # misaligned base would fault on the card and poison the CUDA context
    if xm.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"ln_dense: x and weight must start on 16-byte boundaries, got {xm.data_ptr() % 16}, {w.data_ptr() % 16}")
    m = xm.shape[0]
    out = torch.empty((m, f), dtype=x.dtype, device=x.device)
    lib, stream, gelu = _cuda.library(), _cuda.stream_handle(x), int(activation == "gelu")
    if hopper:
        stats = torch.empty((m, 2), dtype=torch.float32, device=x.device)
        _cuda.check(lib.ud_ln_row_stats(xm.data_ptr(), stats.data_ptr(), m, c, float(eps), stream), "ln_dense")
        err = lib.ud_ln_dense_hopper_fwd(
            xm.data_ptr(), w.data_ptr(), *(t.data_ptr() for t in params), stats.data_ptr(),
            out.data_ptr(), m, c, f, gelu, int(params_bf16), stream,
        )
    else:
        err = lib.ud_ln_dense_fwd(
            xm.data_ptr(), w.data_ptr(), *(t.data_ptr() for t in params),
            out.data_ptr(), m, c, f, float(eps), gelu, _cuda.DTYPE_CODES[x.dtype], stream,
        )
    _cuda.check(err, "ln_dense")
    ln_dense.launches += 1
    ln_dense.hopper_launches += hopper
    return out.reshape(*x.shape[:-1], f)


ln_dense.launches = 0
ln_dense.hopper_launches = 0
