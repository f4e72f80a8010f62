"""K5 conv3x3_lowchannel: the port's op on the CPU (its plain version)
against the JAX Pallas kernel in TPU interpret mode, on the JAX test's three
shapes and padding modes and the V2 hr convs' channel pairs, fp32 at 1e-4
and bf16 at 1.6e-2 (bf16 output rounding); x, w and bias gradients against
``jax.grad`` of the JAX op at 1e-4; and which C entry a card tensor would
launch, with the library stubbed. The V2 heads' fused hr tail
(``conv3x3_head``): its plain version against ``DepthHead._hr_head``'s
modules in fp32, its gradient, the fused entry's arguments with the library
stubbed, and which calls ``DepthHead`` routes to it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
import torch_threads  # noqa: F401  (sets this process's torch thread count)

from unidepth_tpu.ops.conv_kernels import conv3x3_lowchannel as j_conv3x3
from unidepth_tpu_torch.models.unidepthv2 import decoder as decoder_mod
from unidepth_tpu_torch.models.unidepthv2.decoder import DepthHead
from unidepth_tpu_torch.ops.conv_kernels import PAD_MODES, conv3x3_head, conv3x3_head_plain, conv3x3_lowchannel

CASES = [((2, 21, 37, 16, 8), "reflect"), ((1, 10, 40, 32, 16), "zeros"), ((1, 9, 13, 8, 4), "replicate"),
         # the ViT-B and ViT-S hr convs' channels (48 -> 32, 32 -> 32) at a small spatial size
         ((1, 20, 70, 48, 32), "reflect"), ((2, 9, 66, 32, 32), "replicate")]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4), "bfloat16": (jnp.bfloat16, torch.bfloat16, 1.6e-2)}


def _inputs(shape, seed):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, h, w, cin)).astype(np.float32),
        (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32),
        (rng.standard_normal((cout,)) * 0.1).astype(np.float32),
    )


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,mode", CASES)
def test_conv3x3_lowchannel_matches_pallas(shape, mode, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _inputs(shape, sum(shape))
    with pltpu.force_tpu_interpret_mode():
        ref = j_conv3x3(*(jnp.asarray(a, jdt) for a in arrays), mode, 4)
    ref = np.asarray(ref.astype(jnp.float32))
    before = conv3x3_lowchannel.launches
    out = conv3x3_lowchannel(*(torch.from_numpy(a).to(tdt) for a in arrays), mode, 4)
    assert conv3x3_lowchannel.launches == before  # CPU tensors run the plain version
    assert out.dtype == tdt and out.shape == shape[:3] + (shape[4],)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=tol, atol=tol)


def test_conv3x3_lowchannel_without_bias_and_rows_hint():
    """No bias, and ``rows`` (the TPU strip height) changes nothing."""
    x, w, _ = _inputs((1, 9, 13, 8, 4), 3)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(j_conv3x3(jnp.asarray(x), jnp.asarray(w), None, "reflect", 4))
    for rows in (1, 4, 8):
        out = conv3x3_lowchannel(torch.from_numpy(x), torch.from_numpy(w), None, "reflect", rows)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="padding_mode"):
        conv3x3_lowchannel(torch.from_numpy(x), torch.from_numpy(w), None, "circular")


@pytest.mark.parametrize("mode", ["zeros", "reflect", "replicate"])
def test_conv3x3_lowchannel_grads_match_jax(mode):
    x, w, bias = _inputs((1, 8, 12, 8, 4), 7)

    def loss(x, w, bias):
        with pltpu.force_tpu_interpret_mode():
            return jnp.sum(j_conv3x3(x, w, bias, mode, 4) ** 2)

    refs = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, bias)))
    tensors = [torch.from_numpy(a).requires_grad_() for a in (x, w, bias)]
    (conv3x3_lowchannel(*tensors, mode) ** 2).sum().backward()
    for ref, t in zip(refs, tensors):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_conv3x3_lowchannel_grad_of_x_alone():
    """Only the inputs that need a gradient get one."""
    x, w, bias = _inputs((1, 8, 12, 8, 4), 8)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w)
    conv3x3_lowchannel(xt, wt, torch.from_numpy(bias), "zeros").sum().backward()
    assert xt.grad.shape == xt.shape and wt.grad is None


class _EntryRecorder:
    """Stands in for the CUDA library: records which entry was called, and
    its arguments, and reports success."""

    def __init__(self):
        self.calls = []
        self.args = []

    def __getattr__(self, entry):
        return lambda *args: self.calls.append(entry) or self.args.append(args) or 0


@pytest.fixture
def stub_library(monkeypatch):
    from unidepth_tpu_torch.ops import _cuda

    lib = _EntryRecorder()
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "stream_handle", lambda t: 0)
    return lib


HOPPER = "ud_conv3x3_hopper_fwd"


@pytest.mark.parametrize(
    "dtype,cin,cout,entry",
    [(torch.bfloat16, 64, 32, HOPPER), (torch.bfloat16, 48, 32, HOPPER), (torch.bfloat16, 32, 32, HOPPER),
     (torch.bfloat16, 24, 16, HOPPER), (torch.bfloat16, 8, 8, HOPPER), (torch.float32, 64, 32, "ud_conv3x3_fwd"),
     (torch.bfloat16, 64, 4, "ud_conv3x3_fwd"), (torch.bfloat16, 16, 12, "ud_conv3x3_fwd"),
     (torch.float32, 12, 3, "ud_conv3x3_fwd")],
    ids=["bf16-64-32", "bf16-48-32", "bf16-32-32", "bf16-24-16", "bf16-8-8", "fp32-64-32", "bf16-64-4", "bf16-16-12",
         "fp32-12-3"],
)
def test_k5_routes_by_dtype_and_channels(stub_library, dtype, cin, cout, entry):
    """bf16 with Cin and Cout multiples of 8 takes the Hopper body (and
    ``hopper_launches`` moves); fp32, and bf16 at any other Cout, take
    conv3x3.cu's entry."""
    from unidepth_tpu_torch.ops import conv_kernels as ck

    x = torch.zeros(2, 9, 70, cin, dtype=dtype)
    w = torch.zeros(3, 3, cin, cout, dtype=dtype)
    before = ck.conv3x3_lowchannel.launches, ck.conv3x3_lowchannel.hopper_launches
    out = ck._conv_kernel(x, w, torch.zeros(cout, dtype=dtype), "reflect")
    assert out.shape == (2, 9, 70, cout) and out.dtype == dtype
    assert stub_library.calls == [entry]
    after = ck.conv3x3_lowchannel.launches, ck.conv3x3_lowchannel.hopper_launches
    assert after == (before[0] + 1, before[1] + (entry == HOPPER))


def test_k5_unaligned_base_raises_before_the_library(stub_library):
    """A contiguous view that starts 2 bytes into its storage stays
    unaligned through ``contiguous()``: the wrapper raises before any entry
    is called, and nothing is counted."""
    from unidepth_tpu_torch.ops import conv_kernels as ck

    x = torch.zeros(1 + 2 * 9 * 70 * 32, dtype=torch.bfloat16)[1:].view(2, 9, 70, 32)
    assert x.is_contiguous() and x.data_ptr() % 16
    before = ck.conv3x3_lowchannel.launches, ck.conv3x3_lowchannel.hopper_launches
    with pytest.raises(ValueError, match="16-byte"):
        ck._conv_kernel(x, torch.zeros(3, 3, 32, 32, dtype=torch.bfloat16), None, "zeros")
    assert stub_library.calls == []
    assert (ck.conv3x3_lowchannel.launches, ck.conv3x3_lowchannel.hopper_launches) == before


# ---- the V2 heads' hr tail in one K5 launch (conv3x3_head) ----

HEAD = "ud_conv3x3_head_hopper_fwd"
# (Cin, (B, H, W)): the hr convs of ViT-L, ViT-B and ViT-S, widths off and on a multiple of 64
HR_CASES = [(64, (2, 9, 70)), (48, (1, 12, 130)), (32, (2, 7, 64)), (64, (1, 5, 200))]


def _hr_modules(cin, seed):
    torch.manual_seed(seed)
    hr = DepthHead._hr_head(cin)
    with torch.no_grad():
        for p in hr.parameters():  # biases drawn too, not left at 0
            p.normal_(0.0, 0.2)
    return hr


def _hr_args(hr):
    conv, act, proj = hr
    return conv.weight.permute(2, 3, 1, 0), conv.bias, proj.weight.reshape(-1), proj.bias, "reflect", act.negative_slope


@pytest.mark.parametrize("cin,shape", HR_CASES, ids=[f"{c}-{'x'.join(map(str, s))}" for c, s in HR_CASES])
def test_conv3x3_head_plain_matches_the_hr_modules(cin, shape):
    """fp32: reflect 3x3, LeakyReLU and the 1x1 conv of ``_hr_head`` on NCHW
    equal ``conv3x3_head`` on NHWC (its plain version: a CPU tensor)."""
    hr = _hr_modules(cin, sum(shape))
    b, h, w = shape
    x = torch.randn(b, cin, h, w)
    before = conv3x3_lowchannel.launches
    out = conv3x3_head(x.permute(0, 2, 3, 1), *_hr_args(hr))
    assert conv3x3_lowchannel.launches == before
    assert out.shape == (b, h, w, 1)
    torch.testing.assert_close(out.permute(0, 3, 1, 2), hr(x), rtol=1e-5, atol=1e-5)


def test_conv3x3_head_launch_keeps_the_gradient(stub_library, monkeypatch):
    """Through the launch route (the library stubbed), the output requires
    grad and the gradients of x and every weight are the plain version's
    autograd; the backward launches nothing."""
    from unidepth_tpu_torch.ops import conv_kernels as ck

    monkeypatch.setattr(ck, "_conv3x3_head_fwd", ck._head_kernel)  # CPU tensors take the launch
    hr = _hr_modules(16, 3)
    x = torch.randn(1, 6, 10, 16, dtype=torch.bfloat16, requires_grad=True)
    w, bias, w1, b1, mode, slope = _hr_args(hr)
    inputs = [t.detach().to(torch.bfloat16).requires_grad_() for t in (w, bias, w1, b1)]
    out = conv3x3_head(x, *inputs, mode, slope)
    assert out.requires_grad and stub_library.calls == [HEAD]
    g = torch.randn(out.shape, dtype=torch.bfloat16)
    got = torch.autograd.grad(out, [x, *inputs], g)
    assert stub_library.calls == [HEAD]
    want = torch.autograd.grad(conv3x3_head_plain(x, *inputs, mode, slope), [x, *inputs], g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("cin", [64, 48, 32])
def test_k5_head_calls_the_fused_entry(stub_library, cin):
    """bf16 takes ``ud_conv3x3_head_hopper_fwd`` with x read in place, the
    weights, both biases and a (B, H, W, 1) output, and counts as a launch
    of K5's Hopper body."""
    from unidepth_tpu_torch.ops import conv_kernels as ck

    x = torch.zeros(2, 9, 70, cin, dtype=torch.bfloat16)
    w, bias = torch.zeros(3, 3, cin, 32, dtype=torch.bfloat16), torch.zeros(32, dtype=torch.bfloat16)
    w1, b1 = torch.zeros(32, dtype=torch.bfloat16), torch.zeros(1, dtype=torch.bfloat16)
    before = ck.conv3x3_lowchannel.launches, ck.conv3x3_lowchannel.hopper_launches
    out = ck._head_kernel(x, w, bias, w1, b1, "reflect", 0.01)
    assert out.shape == (2, 9, 70, 1) and out.dtype == torch.bfloat16
    assert stub_library.calls == [HEAD]
    (args,) = stub_library.args
    assert args[:6] == tuple(t.data_ptr() for t in (x, w, bias, w1, b1, out))
    assert args[6:] == (2, 9, 70, cin, 32, PAD_MODES["reflect"], 0.01, 0)
    after = ck.conv3x3_lowchannel.launches, ck.conv3x3_lowchannel.hopper_launches
    assert after == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize(
    "dtype,cin,cout,w1_len", [(torch.float32, 64, 32, 32), (torch.bfloat16, 64, 12, 12), (torch.bfloat16, 20, 32, 32),
                              (torch.bfloat16, 64, 32, 16)],
    ids=["fp32", "cout12", "cin20", "w1-short"])
def test_k5_head_raises_off_the_hopper_body(stub_library, dtype, cin, cout, w1_len):
    from unidepth_tpu_torch.ops import conv_kernels as ck

    x = torch.zeros(1, 4, 70, cin, dtype=dtype)
    w = torch.zeros(3, 3, cin, cout, dtype=dtype)
    before = ck.conv3x3_lowchannel.launches
    with pytest.raises(ValueError):
        ck._head_kernel(x, w, None, torch.zeros(w1_len, dtype=dtype), None, "reflect", 0.01)
    assert stub_library.calls == [] and ck.conv3x3_lowchannel.launches == before


@pytest.fixture
def head_calls(monkeypatch):
    """CPU tensors read as CUDA ones to the decoder's route (``is_cuda``),
    and ``conv3x3_head`` records each call, then runs its plain version."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    calls = []

    def recorded(x, *args):
        calls.append(tuple(x.shape))
        assert x.is_contiguous()  # the NHWC resize's output, read in place
        return conv3x3_head_plain(x, *args)

    monkeypatch.setattr(decoder_mod, "conv3x3_head", recorded)
    return calls


# case: (dtype, kernels on, grad enabled, confidence, fused calls)
ROUTES = {
    "bf16-serving": (torch.bfloat16, True, False, True, 2),
    "bf16-depth-only": (torch.bfloat16, True, False, False, 1),
    "fp32": (torch.float32, True, False, True, 0),
    "bf16-autograd": (torch.bfloat16, True, True, True, 0),
    "bf16-kernels-off": (torch.bfloat16, False, False, True, 0),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_depth_head_routes_the_hr_tail(head_calls, case):
    """``DepthHead.heads`` sends each hr tail to K5 for a "CUDA" bf16 map
    that needs no gradient with kernels on; fp32, autograd and
    ``set_kernels(False)`` keep the modules. The fused route's output is the
    modules' within bf16 rounding."""
    dtype, kernels, grad, confidence, fused = ROUTES[case]
    torch.manual_seed(0)
    head = DepthHead(64, num_heads=2, depths=(1, 1, 1), out_dim=64).to(dtype)
    head.use_kernels = kernels
    latents = torch.randn(2, 64, 12, 16, dtype=dtype)
    with torch.set_grad_enabled(grad):
        out = head.heads(latents, (30, 70), confidence)
    assert head_calls == [(2, 30, 70, 32)] * fused
    assert out[0].shape == (2, 1, 30, 70) and (out[1] is not None) == confidence
    if fused:
        head.use_kernels = False
        with torch.no_grad():
            ref = head.heads(latents, (30, 70), confidence)
        for a, b in zip(out, ref):
            if b is not None:
                torch.testing.assert_close(a.float(), b.float(), rtol=1.6e-2, atol=1.6e-2)
