"""Plain versions of the port's attention kernels (K1 flash_attention_qkv,
K3 flash_attention, K4 flash_attention_packed) against the JAX Pallas
kernels run in interpret mode on the CPU, on ragged N, fp32. K1 and K3 are
held at atol 2e-5 under ``safe_attention()``: the row-max kernel bodies,
which the port's kernel follows (it keeps the row max). K4 is held at 1e-5
against the JAX serving default, as tests/test_tp_flash.py runs it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
import torch_threads  # noqa: F401  (sets this process's torch thread count)

from unidepth_tpu.ops.flash_attention import flash_attention as j_flash_attention
from unidepth_tpu.ops.flash_attention import _packed_supported, _xla_attention_packed
from unidepth_tpu.ops.flash_attention import flash_attention_packed as j_flash_attention_packed
from unidepth_tpu.ops.flash_attention import flash_attention_qkv as j_flash_attention_qkv
from unidepth_tpu.ops.flash_attention import safe_attention
from unidepth_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_packed,
    flash_attention_qkv,
    packed_supported,
)

ATOL = 2e-5


@pytest.mark.parametrize("n", [140, 200])
def test_flash_attention_qkv_plain_matches_pallas(n):
    b, c, h = 2, 128, 2
    qkv = (np.random.default_rng(n).standard_normal((b, n, 3 * c)) * 0.3).astype(np.float32)
    # JAX kernel contract: q arrives pre-scaled, so the port runs at scale 1
    with safe_attention():
        ref = j_flash_attention_qkv(jnp.asarray(qkv), h)
    before = flash_attention_qkv.launches
    out = flash_attention_qkv(torch.from_numpy(qkv), h, 1.0)
    assert flash_attention_qkv.launches == before  # CPU tensors run the plain version
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_flash_attention_qkv_scale_is_applied():
    """A softmax scale passed to the port equals pre-scaling q's columns."""
    b, n, c, h, scale = 1, 140, 128, 2, 0.125
    qkv = (np.random.default_rng(0).standard_normal((b, n, 3 * c)) * 0.3).astype(np.float32)
    pre = qkv.copy()
    pre[..., :c] *= scale
    with safe_attention():
        ref = j_flash_attention_qkv(jnp.asarray(pre), h)
    out = flash_attention_qkv(torch.from_numpy(qkv), h, scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("nq,nk", [(140, 140), (200, 200), (140, 200)])
def test_flash_attention_plain_matches_pallas(nq, nk):
    bh, d = 3, 64
    rng = np.random.default_rng(nq + nk)
    q = (rng.standard_normal((bh, nq, d)) * 0.3).astype(np.float32)
    k, v = ((rng.standard_normal((bh, nk, d)) * 0.3).astype(np.float32) for _ in range(2))
    with pltpu.force_tpu_interpret_mode(), safe_attention():
        ref = j_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    before = flash_attention.launches
    out = flash_attention(*map(torch.from_numpy, (q, k, v)), d**-0.5)
    assert flash_attention.launches == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize(
    "b,nq,nk,c,h,views",
    [
        (2, 140, 140, 128, 2, True),  # d=64, strided channel views of one (B, N, 3C) array
        (1, 130, 130, 128, 8, True),  # d=16, ragged N (130 = 128 + 2)
        (2, 140, 200, 128, 4, False),  # d=32, Nq != Nk
        (2, 70, 90, 96, 2, False),  # d=48: outside the packed regime, routed to K3
    ],
    ids=["views-d64", "ragged-d16", "nq-ne-nk-d32", "routed-d48"],
)
def test_flash_attention_packed_plain_matches_pallas(b, nq, nk, c, h, views):
    rng = np.random.default_rng(nq + nk + c)
    if views:
        qkv = (rng.standard_normal((b, nq, 3 * c)) * 0.3).astype(np.float32)
        arrays = qkv[..., :c], qkv[..., c : 2 * c], qkv[..., 2 * c :]
        tensors = torch.from_numpy(qkv).split(c, dim=-1)
        assert tensors[1].stride() == (nq * 3 * c, 3 * c, 1)
    else:
        arrays = tuple(
            (rng.standard_normal((b, n, c)) * 0.3).astype(np.float32) for n in (nq, nk, nk)
        )
        tensors = tuple(map(torch.from_numpy, arrays))
    assert packed_supported(nk, c, h) == _packed_supported(nk, c, h) == (c % 96 != 0)
    ref = j_flash_attention_packed(*map(jnp.asarray, arrays), h)
    before = flash_attention_packed.launches, flash_attention.launches
    out = flash_attention_packed(*tensors, h)  # default scale d**-0.5, as in JAX
    assert (flash_attention_packed.launches, flash_attention.launches) == before
    assert out.shape == (b, nq, c)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("d", [48, 96])
def test_flash_attention_plain_matches_pallas_off_power_of_two_head_dims(d):
    """The ViT-B decoder's head dim (48) and 96, Nq != Nk: the port's K3
    takes them (every multiple of 8 up to 128), as the JAX kernel takes any
    D <= 128."""
    bh, nq, nk = 2, 150, 190
    rng = np.random.default_rng(d)
    q = (rng.standard_normal((bh, nq, d)) * 0.3).astype(np.float32)
    k, v = ((rng.standard_normal((bh, nk, d)) * 0.3).astype(np.float32) for _ in range(2))
    with pltpu.force_tpu_interpret_mode(), safe_attention():
        ref = j_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    before = flash_attention.launches
    out = flash_attention(*map(torch.from_numpy, (q, k, v)), d**-0.5)
    assert flash_attention.launches == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_flash_attention_packed_head_dim_8_matches_jax():
    """d = 8 is inside the JAX packed regime (it divides 128); the port takes
    it too (on the card through the kernel's 16-deep zero-filled step)."""
    b, n, c, h = 2, 150, 128, 16
    rng = np.random.default_rng(8)
    arrays = tuple((rng.standard_normal((b, n, c)) * 0.3).astype(np.float32) for _ in range(3))
    assert packed_supported(n, c, h) and _packed_supported(n, c, h)
    ref = _xla_attention_packed(*map(jnp.asarray, arrays), 8**-0.5, h)
    before = flash_attention_packed.launches, flash_attention.launches
    out = flash_attention_packed(*map(torch.from_numpy, arrays), h)
    assert (flash_attention_packed.launches, flash_attention.launches) == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_packed_supported_matches_jax():
    for nk in (100, 4096, 4097):
        for c, h in ((1024, 16), (128, 8), (128, 16), (96, 6), (256, 1), (384, 2)):
            assert packed_supported(nk, c, h) == _packed_supported(nk, c, h), (nk, c, h)


@pytest.mark.parametrize("offset,match", [(4, "16-byte"), (0, None)])
def test_launch_checks_alignment_before_the_kernel(monkeypatch, offset, match):
    """The launch checks run before the library is touched: a view 8 bytes
    into a row raises; an aligned one reaches the (here stubbed) library."""
    from unidepth_tpu_torch.ops import _cuda, flash_attention as fa

    calls = []

    def library():
        calls.append(1)
        raise RuntimeError("no card")

    monkeypatch.setattr(_cuda, "library", library)
    x = torch.zeros(2, 140, 3 * 128 + 8, dtype=torch.bfloat16)
    q, k, v = x[..., offset : offset + 128], x[..., offset + 128 : offset + 256], x[..., offset + 256 : offset + 384]
    out = torch.empty(2, 140, 128, dtype=torch.bfloat16)
    strides = (q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1), 140 * 128, 128)
    args = ("k4", q, k.data_ptr(), v.data_ptr(), out, 2, 2, 140, 140, 64, strides, 0.125)
    with pytest.raises(ValueError if match else RuntimeError, match=match or "no card"):
        fa._launch(*args)
    assert len(calls) == (0 if match else 1)


def test_failed_build_is_not_retried(monkeypatch):
    """A failed build raises at every call without running nvcc again."""
    from unidepth_tpu_torch.ops import _cuda

    calls = []

    def build():
        calls.append(1)
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(_cuda, "build", build)
    monkeypatch.setattr(_cuda, "_lib", None)
    monkeypatch.setattr(_cuda, "_build_error", None)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            _cuda.library()
    assert len(calls) == 1


class _EntryRecorder:
    """A stand-in for the kernel library: records which C entry was called
    and reports success."""

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


HOPPER = "ud_attention_hopper_fwd"


@pytest.mark.parametrize(
    "dtype,d,entry",
    [(torch.bfloat16, 64, HOPPER), (torch.float32, 64, "ud_attention_fwd"), (torch.bfloat16, 32, "ud_attention_fwd")],
    ids=["bf16-d64", "fp32-d64", "bf16-d32"],
)
def test_k1_routes_by_dtype_and_head_dim(stub_library, dtype, d, entry):
    """K1 takes the Hopper body for bf16 at D = 64 and attention.cu's body
    otherwise; ``hopper_launches`` counts only the former."""
    from unidepth_tpu_torch.ops import flash_attention as fa

    qkv = torch.zeros(2, 140, 3 * 128, dtype=dtype)
    before = fa.flash_attention_qkv.launches, fa.flash_attention_qkv.hopper_launches
    out = fa._qkv_kernel(qkv, 128 // d, 0.125)
    assert out.shape == (2, 140, 128) and out.dtype == dtype
    assert stub_library.calls == [entry]
    after = fa.flash_attention_qkv.launches, fa.flash_attention_qkv.hopper_launches
    assert after == (before[0] + 1, before[1] + (entry == HOPPER))


@pytest.mark.parametrize(
    "dtype,d,entry",
    [(torch.bfloat16, 64, HOPPER), (torch.float32, 64, "ud_attention_packed_fwd"),
     (torch.bfloat16, 32, "ud_attention_packed_fwd")],
    ids=["bf16-d64", "fp32-d64", "bf16-d32"],
)
def test_k4_routes_by_dtype_and_head_dim(stub_library, dtype, d, entry):
    """K4 on the strided views of one projection: the Hopper body for bf16
    at D = 64, its packed entry of attention.cu otherwise."""
    from unidepth_tpu_torch.ops import flash_attention as fa

    q, k, v = torch.zeros(2, 140, 3 * 128, dtype=dtype).split(128, dim=-1)
    before = fa.flash_attention_packed.launches, fa.flash_attention_packed.hopper_launches
    fa._packed_kernel(q, k, v, 128 // d, 0.125)
    assert stub_library.calls == [entry]
    after = fa.flash_attention_packed.launches, fa.flash_attention_packed.hopper_launches
    assert after == (before[0] + 1, before[1] + (entry == HOPPER))


@pytest.mark.parametrize(
    "dtype,d,nk,entry",
    [(torch.bfloat16, 64, 100, HOPPER), (torch.bfloat16, 64, 5000, HOPPER), (torch.float32, 64, 100, "ud_attention_fwd"),
     (torch.bfloat16, 32, 100, HOPPER), (torch.float32, 32, 100, "ud_attention_fwd"),
     (torch.bfloat16, 48, 100, HOPPER), (torch.float32, 48, 100, "ud_attention_fwd"),
     (torch.bfloat16, 96, 100, "ud_attention_fwd"), (torch.float32, 96, 100, "ud_attention_fwd")],
    ids=["bf16-d64", "bf16-d64-nk5000", "fp32-d64", "bf16-d32", "fp32-d32", "bf16-d48", "fp32-d48", "bf16-d96",
         "fp32-d96"],
)
def test_k3_routes_by_dtype_and_head_dim(stub_library, dtype, d, nk, entry):
    """K3 takes the Hopper body for bf16 at D = 64, 48 and 32 (flat (BH, N,
    D) tensors as BH batches of one head; any Nk, past the TPU kernel's 4096
    too) and attention.cu's body otherwise (fp32, D = 96); only its own
    ``hopper_launches`` moves."""
    from unidepth_tpu_torch.ops import flash_attention as fa

    q = torch.zeros(4, 100, d, dtype=dtype)
    k, v = (torch.zeros(4, nk, d, dtype=dtype) for _ in range(2))
    others = fa.flash_attention_qkv.hopper_launches, fa.flash_attention_packed.hopper_launches
    before = fa.flash_attention.launches, fa.flash_attention.hopper_launches
    out = fa._flash_kernel(q, k, v, d**-0.5)
    assert out.shape == (4, 100, d) and out.dtype == dtype
    assert stub_library.calls == [entry]
    after = fa.flash_attention.launches, fa.flash_attention.hopper_launches
    assert after == (before[0] + 1, before[1] + (entry == HOPPER))
    assert (fa.flash_attention_qkv.hopper_launches, fa.flash_attention_packed.hopper_launches) == others


@pytest.mark.parametrize("scale", [0.0, -0.125, float("inf")])
def test_hopper_route_refuses_a_scale_it_cannot_take(stub_library, scale):
    """The Hopper body takes its row max on the raw scores, so it needs a
    positive finite scale: anything else raises before the library is
    called, and no other body is tried."""
    from unidepth_tpu_torch.ops import flash_attention as fa

    qkv = torch.zeros(1, 70, 3 * 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="scale"):
        fa._qkv_kernel(qkv, 2, scale)
    q = torch.zeros(2, 70, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="scale"):
        fa._flash_kernel(q, q, q, scale)
    assert stub_library.calls == []


def test_supported_head_dims_are_the_multiples_of_8():
    from unidepth_tpu_torch.ops import flash_attention as fa

    assert fa.SUPPORTED_HEAD_DIMS == tuple(range(8, 129, 8))


@pytest.mark.parametrize("d", [20, 132])
def test_k3_head_dim_off_the_grid_raises_before_the_library(stub_library, d):
    """A head dim that is not a multiple of 8 (16-byte rows), or past 128,
    raises before the library is touched; no other body is tried."""
    from unidepth_tpu_torch.ops import flash_attention as fa

    q = torch.zeros(2, 70, d, dtype=torch.bfloat16)
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match="head dim"):
        fa._flash_kernel(q, q, q, d**-0.5)
    assert stub_library.calls == [] and fa.flash_attention.launches == before


@pytest.mark.parametrize("kernel", ["k1", "k4"])
@pytest.mark.parametrize("c,heads", [(96, 2), (64, 2), (48, 1), (32, 1)], ids=["d48-h2", "d32-h2", "d48-h1", "d32-h1"])
def test_k1_and_k4_keep_attention_cu_at_head_dims_32_and_48(stub_library, kernel, c, heads):
    """K1 and K4 read heads packed in one row, where the Hopper body's
    64-channel box at D < 64 would reach into the next head: in bf16 at D =
    32 and 48 they launch attention.cu's bodies, whatever the head count."""
    from unidepth_tpu_torch.ops import flash_attention as fa

    x = torch.zeros(2, 140, 3 * c, dtype=torch.bfloat16)
    fn = fa.flash_attention_qkv if kernel == "k1" else fa.flash_attention_packed
    before = fa.flash_attention_qkv.hopper_launches, fa.flash_attention_packed.hopper_launches, fn.launches
    if kernel == "k1":
        fa._qkv_kernel(x, heads, (c // heads) ** -0.5)
    else:
        fa._packed_kernel(*x.split(c, dim=-1), heads, (c // heads) ** -0.5)
    assert stub_library.calls == ["ud_attention_fwd" if kernel == "k1" else "ud_attention_packed_fwd"]
    assert (fa.flash_attention_qkv.hopper_launches, fa.flash_attention_packed.hopper_launches, fn.launches) == (
        before[0], before[1], before[2] + 1)


@pytest.mark.parametrize(
    "dtype,d,heads,hopper",
    [(torch.bfloat16, 64, None, True), (torch.bfloat16, 64, 16, True), (torch.bfloat16, 48, 1, True),
     (torch.bfloat16, 32, 1, True), (torch.bfloat16, 48, 2, False), (torch.bfloat16, 32, 8, False),
     (torch.bfloat16, 48, None, False), (torch.bfloat16, 96, 1, False), (torch.bfloat16, 16, 1, False),
     (torch.float32, 48, 1, False), (torch.float32, 64, None, False)],
)
def test_entry_mirrors_the_hopper_entrys_one_head_rule(dtype, d, heads, hopper):
    """``_entry`` holds the C entry's rule: the Hopper body takes bf16 at D =
    64 for any head count, and D = 32 or 48 only for a map of one head."""
    from unidepth_tpu_torch.ops import flash_attention as fa

    assert (fa._entry(dtype, d, "other", heads=heads) == fa.HOPPER_ENTRY) is hopper
