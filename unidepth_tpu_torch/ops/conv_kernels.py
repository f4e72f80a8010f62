"""3x3 stride-1 "same" convolution for few output channels: the CUDA kernels
``csrc/conv3x3_wgmma.cu`` and ``csrc/conv3x3.cu`` (kernel K5) and its plain
PyTorch version (counterpart of unidepth_tpu/ops/conv_kernels.py).

``conv3x3_lowchannel`` replaces the TPU kernel of the same name
(``_conv3x3_fwd`` / ``_kernel``) and keeps its layout: x (B, H, W, Cin)
NHWC, w (3, 3, Cin, Cout) HWIO, bias (Cout,) or None, zeros / reflect /
replicate padding, fp32 accumulation; it returns (B, H, W, Cout) in x's
dtype. No model of the repository calls it, as in the JAX package: its
entry point is the op itself.

``conv3x3_head`` is the V2 heads' high-resolution tail in one launch of
the Hopper body (``DepthHead._hr_head``: this conv, LeakyReLU, a 1x1 conv
to one channel; ``models/unidepthv2/decoder.py`` routes its bf16 serving
calls here): the row's conv output goes through the LeakyReLU and the 1x1
conv in registers, so the (B, H, W, Cout) map is never written, and
``conv3x3_head_plain`` composes the same modules, each in x's dtype. It
takes what the Hopper body takes (bf16, Cin and Cout multiples of 8);
other CUDA tensors raise.

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
among them, ``conv3x3_head``'s included; each launch runs in the host span
``unidepth.kernel.K5`` (``utils/tracing.py``). The gradient recomputes
through the plain version's autograd, as the JAX ``custom_vjp`` recomputes
with XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from unidepth_tpu_torch.ops import _cuda
from unidepth_tpu_torch.utils import tracing

__all__ = ["conv3x3_lowchannel", "conv3x3_lowchannel_plain", "conv3x3_head", "conv3x3_head_plain"]

PAD_MODES = {"zeros": 0, "reflect": 1, "replicate": 2}
_TORCH_PAD = {"zeros": "constant", "reflect": "reflect", "replicate": "replicate"}
MAX_CIN, MAX_COUT = 64, 32
HOPPER_ENTRY = "ud_conv3x3_hopper_fwd"  # conv3x3_wgmma.cu: bf16, Cin and Cout multiples of 8
HEAD_ENTRY = "ud_conv3x3_head_hopper_fwd"  # the same body with the head's epilogue


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


def conv3x3_head_plain(x, w, bias, w1, b1, padding_mode: str = "reflect", negative_slope: float = 0.01):
    """``conv3x3_lowchannel_plain``, LeakyReLU and the 1x1 conv to one
    channel (w1 (Cout,), b1 (1,) or None), each in x's dtype as the modules
    compute them: the 1x1 sums in fp32, rounds, then adds its bias.
    (B, H, W, 1)."""
    y = F.leaky_relu(conv3x3_lowchannel_plain(x, w, bias, padding_mode), negative_slope)
    out = (_cuda.wide(y) @ _cuda.wide(w1.to(x.dtype)).reshape(-1, 1)).to(x.dtype)
    return out if b1 is None else out + b1.to(x.dtype)


def _entry(dtype: torch.dtype, cin: int, cout: int) -> str:
    """The C entry K5 launches: the Hopper body for bf16 with Cin and Cout
    multiples of 8, else conv3x3.cu's (mma.sync in bf16, CUDA cores in fp32)."""
    return HOPPER_ENTRY if dtype == torch.bfloat16 and cin % 8 == 0 and cout % 8 == 0 else "ud_conv3x3_fwd"


def _conv3x3_fwd(x, w, bias, padding_mode: str):
    if x.device.type == "cpu":
        return conv3x3_lowchannel_plain(x, w, bias, padding_mode)
    _cuda.require_cuda("conv3x3_lowchannel", *(t for t in (x, w, bias) if t is not None))
    return _conv_kernel(x, w, bias, padding_mode)


def _checked(x, w, bias, padding_mode: str, name: str = "conv3x3_lowchannel"):
    """K5's checks of what its kernels take; x, w and bias contiguous, w and
    bias in x's dtype."""
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    if w.shape != (3, 3, cin, cout) or (bias is not None and bias.shape != (cout,)):
        raise ValueError(f"{name}: w {tuple(w.shape)} / bias does not fit x {tuple(x.shape)}")
    if cin > MAX_CIN or cout > MAX_COUT:
        raise ValueError(f"{name}: Cin {cin} > {MAX_CIN} or Cout {cout} > {MAX_COUT} has no kernel")
    if x.dtype == torch.bfloat16 and cin % 8:
        raise ValueError(f"{name}: bf16 Cin {cin} must be a multiple of 8")
    if padding_mode == "reflect" and min(h, wd) < 2:
        raise ValueError(f"{name}: reflect padding needs H and W >= 2")
    w = w.to(x.dtype).contiguous()
    bias = None if bias is None else bias.to(x.dtype).contiguous()
    x = x.contiguous()
    # the kernels load x with 16-byte copies (TMA in the Hopper body); a
    # misaligned base would fault on the card and poison the CUDA context
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: x must start on a 16-byte boundary")
    return x, w, bias


def _launch(entry: str, x, *args) -> None:
    """One launch of K5's C ``entry`` on x's stream, in its span, counted."""
    with tracing.span("unidepth.kernel.K5"):
        err = getattr(_cuda.library(), entry)(*args, _cuda.stream_handle(x))
    _cuda.check(err, entry)
    conv3x3_lowchannel.launches += 1
    conv3x3_lowchannel.hopper_launches += entry in (HOPPER_ENTRY, HEAD_ENTRY)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _conv_kernel(x, w, bias, padding_mode: str):
    """K5's launch, on whatever device ``x`` is (the CPU tests call it with
    the library stubbed to see the route)."""
    x, w, bias = _checked(x, w, bias, padding_mode)
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    out = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    entry = _entry(x.dtype, cin, cout)
    args = (x.data_ptr(), w.data_ptr(), _ptr(bias), out.data_ptr(), b, h, wd, cin, cout, PAD_MODES[padding_mode])
    if entry != HOPPER_ENTRY:
        args += (_cuda.DTYPE_CODES[x.dtype],)  # conv3x3.cu's entry takes fp32 and bf16
    _launch(entry, x, *args)
    return out


def _head_kernel(x, w, bias, w1, b1, padding_mode: str, negative_slope: float):
    """``conv3x3_head``'s launch, on whatever device ``x`` is (the CPU
    tests call it with the library stubbed)."""
    name = "conv3x3_head"
    x, w, bias = _checked(x, w, bias, padding_mode, name)
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    if _entry(x.dtype, cin, cout) != HOPPER_ENTRY:
        raise ValueError(f"{name}: {x.dtype} Cin {cin} -> Cout {cout} is not on the Hopper body (bf16, multiples of 8)")
    if w1.numel() != cout or (b1 is not None and b1.numel() != 1):
        raise ValueError(f"{name}: the 1x1 weights {tuple(w1.shape)} / bias do not map Cout {cout} to one channel")
    w1 = w1.to(x.dtype).contiguous()
    b1 = None if b1 is None else b1.to(x.dtype).contiguous()
    out = torch.empty((b, h, wd, 1), dtype=x.dtype, device=x.device)
    args = (x.data_ptr(), w.data_ptr(), _ptr(bias), w1.data_ptr(), _ptr(b1), out.data_ptr(), b, h, wd, cin, cout)
    _launch(HEAD_ENTRY, x, *args, PAD_MODES[padding_mode], float(negative_slope))
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


def _conv3x3_head_fwd(x, w, bias, w1, b1, padding_mode: str, negative_slope: float):
    if x.device.type == "cpu":
        return conv3x3_head_plain(x, w, bias, w1, b1, padding_mode, negative_slope)
    _cuda.require_cuda("conv3x3_head", *(t for t in (x, w, bias, w1, b1) if t is not None))
    return _head_kernel(x, w, bias, w1, b1, padding_mode, negative_slope)


class _Conv3x3Head(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, w1, b1, padding_mode, negative_slope):
        ctx.save_for_backward(x, w, bias, w1, b1)
        ctx.args = padding_mode, negative_slope
        return _conv3x3_head_fwd(x, w, bias, w1, b1, padding_mode, negative_slope)

    @staticmethod
    def backward(ctx, g):
        fn = lambda *t: conv3x3_head_plain(*t, *ctx.args)  # noqa: E731
        return (*_cuda.plain_vjp(fn, ctx.saved_tensors, ctx.needs_input_grad[:5], g), None, None)


def conv3x3_head(x, w, bias, w1, b1=None, padding_mode: str = "reflect", negative_slope: float = 0.01):
    """``DepthHead._hr_head`` on NHWC in one K5 launch: the 3x3 conv of
    ``conv3x3_lowchannel`` (x (B, H, W, Cin), w (3, 3, Cin, Cout), bias
    (Cout,) or None), LeakyReLU(``negative_slope``), then the 1x1 conv to one
    channel, w1 (Cout,), b1 (1,) or None -> (B, H, W, 1) in x's dtype."""
    _check_mode(padding_mode)
    return _Conv3x3Head.apply(x, w, bias, w1, b1, padding_mode, negative_slope)
