"""Plain version of the port's ln_dense kernel (K2) against the JAX package:
the XLA formulation ``_xla_ln_dense`` (exact erf GELU) at atol 1e-5, and the
Pallas ``ln_dense`` run in interpret mode on the CPU (A&S erf, measured
2.9e-6 from the exact erf) at atol 3e-5. fp32, eps 1e-6 (ViT) and 1e-5
(decoder ConvNeXt blocks)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidepth_tpu.ops.fused_block import _xla_ln_dense
from unidepth_tpu.ops.fused_block import ln_dense as j_ln_dense
from unidepth_tpu_torch.ops.fused_block import ln_dense


def _inputs(seed, m=300, c=128, f=384):
    rng = np.random.default_rng(seed)
    return (
        (rng.standard_normal((2, m // 2, c)) * 2 + 0.5).astype(np.float32),
        (rng.standard_normal((f, c)) / np.sqrt(c)).astype(np.float32),  # (F, C) nn.Linear layout
        (rng.standard_normal(f) * 0.1).astype(np.float32),
        (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
        (0.1 * rng.standard_normal(c)).astype(np.float32),
    )


def _port(x, w, b, g, bt, eps, act):
    before = ln_dense.launches
    out = ln_dense(*map(torch.from_numpy, (x, w, b, g, bt)), eps, act).numpy()
    assert ln_dense.launches == before  # CPU tensors run the plain version
    return out


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
@pytest.mark.parametrize("act", [None, "gelu"])
def test_ln_dense_plain_matches_xla(eps, act):
    x, w, b, g, bt = _inputs(0)
    ref = _xla_ln_dense(jnp.asarray(x), jnp.asarray(w.T), jnp.asarray(b), jnp.asarray(g), jnp.asarray(bt), eps, act)
    np.testing.assert_allclose(_port(x, w, b, g, bt, eps, act), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_ln_dense_plain_matches_pallas(eps):
    x, w, b, g, bt = _inputs(1)
    ref = j_ln_dense(jnp.asarray(x), jnp.asarray(w.T), jnp.asarray(b), jnp.asarray(g), jnp.asarray(bt), eps, "gelu")
    np.testing.assert_allclose(_port(x, w, b, g, bt, eps, "gelu"), np.asarray(ref), atol=3e-5, rtol=0)


def test_ln_dense_rejects_unknown_activation():
    x, w, b, g, bt = map(torch.from_numpy, _inputs(2, m=4))
    with pytest.raises(ValueError, match="activation"):
        ln_dense(x, w, b, g, bt, 1e-6, "relu")
