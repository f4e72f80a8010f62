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
