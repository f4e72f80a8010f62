"""K6 and K7, the A/B attention variants: the port's ``run_variant`` on the
CPU (the plain versions) against the JAX harness ``scripts/kernel_ab.py``,
whose Pallas kernels run in interpret mode on the CPU, at a ragged N. fp32
is held at 1e-5 relative, bf16 at 1.6e-2 (bf16 output rounding); ``noexp``
(outputs ~1e31, a divisor of 1e-30) by its relative RMS error alone."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidepth_tpu_torch.ops.kernel_ab import family, run_bd, run_variant

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5), "bfloat16": (jnp.bfloat16, torch.bfloat16, 1.6e-2)}
# every name the JAX harness branches on, and the family each computes
FAMILIES = {
    "tr_max": "M1", "softmax": "M1",
    "bf16p": "M2", "lmxu": "M2", "bf16p+lmxu": "M2",
    "nomax_guard": "M3", "tr": "M3", "kt_guard": "M3", "oneblk": "M3",
    "tr_lmxu": "M4",
    "nomax": "M5",
    "noexp": "M6",
    "gemmonly": "M7", "tr_gemmonly": "M7",
    "qk_only": "M8", "kt": "M8",
    "pv_only": "M9",
}
BD_NAMES = ["bd", "bd_lmxu", "bd352", "bd176"]


@pytest.fixture(scope="module")
def jax_ab():
    spec = importlib.util.spec_from_file_location("jax_kernel_ab", ROOT / "scripts" / "kernel_ab.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _compare(jax_ab, variant, dtype, heads, d):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(len(variant))
    arrays = [rng.standard_normal((1, 150, heads * d)).astype(np.float32) for _ in range(3)]
    scale = d**-0.5
    ref = jax_ab.run_variant(variant, *(jnp.asarray(a, jdt) for a in arrays), heads, scale)
    ref = np.asarray(ref.astype(jnp.float32))
    out = run_variant(variant, *(torch.from_numpy(a).to(tdt) for a in arrays), heads, scale)
    assert out.dtype == tdt and out.shape == ref.shape
    out = out.float().numpy()
    top = np.abs(ref).max()
    if variant == "noexp":
        assert np.linalg.norm((out - ref) / top) <= tol * np.linalg.norm(ref / top)
    else:
        np.testing.assert_allclose(out, ref, rtol=tol, atol=tol * top)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", ["base", *FAMILIES])
def test_run_variant_matches_jax_harness(jax_ab, variant, dtype):
    before = run_variant.launches, run_bd.launches
    _compare(jax_ab, variant, dtype, heads=4, d=32)
    assert (run_variant.launches, run_bd.launches) == before  # CPU tensors run the plain versions


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", BD_NAMES)
def test_run_bd_matches_jax_harness(jax_ab, variant, dtype):
    before = run_bd.launches
    _compare(jax_ab, variant, dtype, heads=4, d=64)
    assert run_bd.launches == before


def test_family_table():
    assert {name: family(name) for name in FAMILIES} == FAMILIES
    for name in ("base", "bd", "bd_lmxu"):
        with pytest.raises(ValueError, match="not a K6 variant"):
            family(name)


@pytest.mark.parametrize("heads,d", [(4, 32), (3, 64)], ids=["d32", "odd-heads"])
def test_run_bd_domain(heads, d):
    """Head pairs of 64 only; JAX fails in a reshape (TypeError) at d = 32."""
    q = torch.zeros(1, 150, heads * d)
    with pytest.raises(ValueError, match="head pairs of 64"):
        run_bd(q, q, q, heads, d**-0.5)
