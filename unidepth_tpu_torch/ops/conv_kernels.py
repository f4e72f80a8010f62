"""3x3 stride-1 "same" convolution for few output channels: the CUDA kernels
``csrc/conv3x3_wgmma.cu`` and ``csrc/conv3x3.cu`` (kernel K5) and its plain
PyTorch version (counterpart of unidepth_tpu/ops/conv_kernels.py).

``conv3x3_lowchannel`` replaces the TPU kernel of the same name
(``_conv3x3_fwd`` / ``_kernel``) and keeps its layout: x (B, H, W, Cin)
NHWC, w (3, 3, Cin, Cout) HWIO, bias (Cout,) or None, zeros / reflect /
replicate padding, fp32 accumulation; it returns (B, H, W, Cout) in x's
dtype. No model of the repository calls it, as in the JAX package: its
entry point is the op itself.

On the H100 the V2 heads' hr conv shape, (8, 518, 518, 64 -> 32) bf16, is
bound by memory (79.1 GFLOP against 412 MB, 0.123 ms at 3.35 TB/s). Which
body runs is fixed by dtype and shape, never by a failure:

* bf16 with Cin and Cout multiples of 8 (the hr convs of every V2 config:
  64, 48 or 32 -> 32) runs the Hopper body (``conv3x3_wgmma.cu``): a TMA
  ring of input rows, one wgmma m64n{3 Cout}k16 per shift and 16 channels
  that adds all three row taps, the padding a choice of TMA coordinate or
  of ldmatrix address, so x is read about once and no padded copy of it is
  written (see the source);
* bf16 with another Cout (3, 4, 12, ...) runs the mma.sync implicit GEMM of
  ``conv3x3.cu``;
* fp32 runs the CUDA-core kernel of ``conv3x3.cu``, exact fp32 without TF32.

The card takes Cin <= 64 (bf16: a multiple of 8) and Cout <= 32, which
covers every shape the JAX tests use; other shapes raise on the card.

A CPU tensor takes the plain version. A CUDA tensor launches the kernel, or
raises when it cannot: nothing falls back. ``conv3x3_lowchannel.launches``
counts the kernel launches, ``hopper_launches`` those of the Hopper body
among them. The gradient recomputes through the plain version's autograd,
as the JAX ``custom_vjp`` recomputes with XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from unidepth_tpu_torch.ops import _cuda

__all__ = ["conv3x3_lowchannel", "conv3x3_lowchannel_plain"]

PAD_MODES = {"zeros": 0, "reflect": 1, "replicate": 2}
_TORCH_PAD = {"zeros": "constant", "reflect": "reflect", "replicate": "replicate"}
MAX_CIN, MAX_COUT = 64, 32
HOPPER_ENTRY = "ud_conv3x3_hopper_fwd"  # conv3x3_wgmma.cu: bf16, Cin and Cout multiples of 8


def _check_mode(padding_mode: str) -> None:
    if padding_mode not in PAD_MODES:
        raise ValueError(f"conv3x3_lowchannel: padding_mode {padding_mode!r} not in {tuple(PAD_MODES)}")


def conv3x3_lowchannel_plain(x, w, bias, padding_mode: str = "zeros"):
    """Pad by mode, VALID 3x3 conv with fp32 accumulation, cast to x's dtype,
    then add the bias in x's dtype (``_xla_conv3x3``)."""
    _check_mode(padding_mode)
    xp = F.pad(x.permute(0, 3, 1, 2).float(), (1, 1, 1, 1), mode=_TORCH_PAD[padding_mode])
    out = F.conv2d(xp, w.to(x.dtype).float().permute(3, 2, 0, 1))
    out = out.permute(0, 2, 3, 1).to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def _entry(dtype: torch.dtype, cin: int, cout: int) -> str:
    """The C entry K5 launches: the Hopper body for bf16 with Cin and Cout
    multiples of 8, else conv3x3.cu's (mma.sync in bf16, CUDA cores in fp32)."""
    return HOPPER_ENTRY if dtype == torch.bfloat16 and cin % 8 == 0 and cout % 8 == 0 else "ud_conv3x3_fwd"


def _conv3x3_fwd(x, w, bias, padding_mode: str):
    if x.device.type == "cpu":
        return conv3x3_lowchannel_plain(x, w, bias, padding_mode)
    _cuda.require_cuda("conv3x3_lowchannel", *(t for t in (x, w, bias) if t is not None))
    return _conv_kernel(x, w, bias, padding_mode)


def _conv_kernel(x, w, bias, padding_mode: str):
    """K5's launch, on whatever device ``x`` is (the CPU tests call it with
    the library stubbed to see the route)."""
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    if w.shape != (3, 3, cin, cout) or (bias is not None and bias.shape != (cout,)):
        raise ValueError(f"conv3x3_lowchannel: w {tuple(w.shape)} / bias does not fit x {tuple(x.shape)}")
    if cin > MAX_CIN or cout > MAX_COUT:
        raise ValueError(f"conv3x3_lowchannel: Cin {cin} > {MAX_CIN} or Cout {cout} > {MAX_COUT} has no kernel")
    if x.dtype == torch.bfloat16 and cin % 8:
        raise ValueError(f"conv3x3_lowchannel: bf16 Cin {cin} must be a multiple of 8")
    if padding_mode == "reflect" and min(h, wd) < 2:
        raise ValueError("conv3x3_lowchannel: reflect padding needs H and W >= 2")
    w = w.to(x.dtype).contiguous()
    bias = None if bias is None else bias.to(x.dtype).contiguous()
    x = x.contiguous()
    # the kernels load x with 16-byte copies (TMA in the Hopper body); a
    # misaligned base would fault on the card and poison the CUDA context
    if x.data_ptr() % 16:
        raise ValueError("conv3x3_lowchannel: x must start on a 16-byte boundary")
    out = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    entry = _entry(x.dtype, cin, cout)
    ptrs = (x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr())
    mode = PAD_MODES[padding_mode]
    lib = _cuda.library()
    if entry == HOPPER_ENTRY:
        err = lib.ud_conv3x3_hopper_fwd(*ptrs, b, h, wd, cin, cout, mode, _cuda.stream_handle(x))
    else:
        err = lib.ud_conv3x3_fwd(*ptrs, b, h, wd, cin, cout, mode, _cuda.DTYPE_CODES[x.dtype], _cuda.stream_handle(x))
    _cuda.check(err, "conv3x3_lowchannel")
    conv3x3_lowchannel.launches += 1
    conv3x3_lowchannel.hopper_launches += entry == HOPPER_ENTRY
    return out


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, padding_mode):
        ctx.save_for_backward(x, w, bias)
        ctx.padding_mode = padding_mode
        return _conv3x3_fwd(x, w, bias, padding_mode)

    @staticmethod
    def backward(ctx, g):
        fn = lambda x, w, bias: conv3x3_lowchannel_plain(x, w, bias, ctx.padding_mode)  # noqa: E731
        return (*_cuda.plain_vjp(fn, ctx.saved_tensors, ctx.needs_input_grad[:3], g), None)


def conv3x3_lowchannel(x, w, bias=None, padding_mode: str = "zeros", rows: int = 8):
    """3x3 stride-1 'same' conv for small Cout; x (B, H, W, Cin), w (3, 3,
    Cin, Cout), bias (Cout,) or None -> (B, H, W, Cout) in x's dtype.

    ``rows`` is the TPU kernel's strip height, kept for the JAX signature as
    a tile hint: the card's kernels tile by their own rules and the result
    does not depend on it."""
    _check_mode(padding_mode)
    if rows < 1:
        raise ValueError(f"conv3x3_lowchannel: rows {rows} < 1")
    return _Conv3x3.apply(x, w, bias, padding_mode)


conv3x3_lowchannel.launches = 0
conv3x3_lowchannel.hopper_launches = 0
