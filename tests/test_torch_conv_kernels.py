"""K5 conv3x3_lowchannel: the port's op on the CPU (its plain version)
against the JAX Pallas kernel in TPU interpret mode, on the JAX test's three
shapes and padding modes and the V2 hr convs' channel pairs, fp32 at 1e-4
and bf16 at 1.6e-2 (bf16 output rounding); x, w and bias gradients against
``jax.grad`` of the JAX op at 1e-4; and which C entry a card tensor would
launch, with the library stubbed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from unidepth_tpu.ops.conv_kernels import conv3x3_lowchannel as j_conv3x3
from unidepth_tpu_torch.ops.conv_kernels import conv3x3_lowchannel

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
    """Stands in for the CUDA library: records which entry was called and
    reports success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        return lambda *args: self.calls.append(entry) or 0


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
