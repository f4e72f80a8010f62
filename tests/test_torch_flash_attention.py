"""Plain versions of the port's attention kernels (K1 flash_attention_qkv,
K3 flash_attention) against the JAX Pallas kernels run in interpret mode on
the CPU, on ragged N, fp32, atol 2e-5. The JAX calls run under
``safe_attention()``: the row-max kernel bodies, which the port's kernel
follows (it keeps the row max)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from unidepth_tpu.ops.flash_attention import flash_attention as j_flash_attention
from unidepth_tpu.ops.flash_attention import flash_attention_qkv as j_flash_attention_qkv
from unidepth_tpu.ops.flash_attention import safe_attention
from unidepth_tpu_torch.ops.flash_attention import flash_attention, flash_attention_qkv

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
