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
import torch_threads  # noqa: F401  (sets this process's torch thread count)

from unidepth_tpu_torch.ops import kernel_ab as ab
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


class _EntryRecorder:
    """A stand-in for the kernel library: records which C entry was called
    with which arguments, and reports success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        return lambda *args: self.calls.append((entry, args)) or 0


@pytest.fixture
def stub_library(monkeypatch):
    from unidepth_tpu_torch.ops import _cuda

    lib = _EntryRecorder()
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "stream_handle", lambda t: 0)
    return lib


FAMILY_NAMES = {"M1": "tr_max", "M2": "bf16p", "M3": "nomax_guard", "M4": "tr_lmxu", "M5": "nomax", "M6": "noexp",
                "M7": "gemmonly", "M8": "qk_only", "M9": "pv_only"}


@pytest.mark.parametrize("fam", list(FAMILY_NAMES))
def test_k6_at_head_dim_64_routes_to_the_hopper_entry(stub_library, fam):
    """Every K6 family in bf16 at D = 64 reaches the Hopper entry with its
    family code and the tensors' element strides, and counts
    ``hopper_launches``."""
    q, k, v = (torch.zeros(2, n, 4 * 64, dtype=torch.bfloat16) for n in (150, 300, 300))
    before = run_variant.launches, run_variant.hopper_launches
    out = ab._ab_kernel(family(FAMILY_NAMES[fam]), q, k, v, 4)
    assert out.shape == (2, 150, 256) and out.dtype == torch.bfloat16
    [(entry, args)] = stub_library.calls
    assert entry == "ud_attention_ab_hopper_fwd"
    assert args[4:8] == (2, 4, 150, 300)  # batch, heads, nq, nk
    assert args[8:16] == (150 * 256, 256, 300 * 256, 256, 300 * 256, 256, 150 * 256, 256)
    assert args[16] == int(fam[1])
    assert (run_variant.launches, run_variant.hopper_launches) == (before[0] + 1, before[1] + 1)


def test_k6_at_head_dim_32_routes_to_the_mma_sync_entry(stub_library):
    q = torch.zeros(2, 150, 4 * 32, dtype=torch.bfloat16)
    before = run_variant.launches, run_variant.hopper_launches
    ab._ab_kernel("M3", q, q, q, 4)
    assert [entry for entry, _ in stub_library.calls] == ["ud_attention_ab_fwd"]
    assert (run_variant.launches, run_variant.hopper_launches) == (before[0] + 1, before[1])


@pytest.mark.parametrize("fam,l_from_bf16", [("M3", 0), ("M4", 1)])
def test_k7_routes_to_its_hopper_entry(stub_library, fam, l_from_bf16):
    q = torch.zeros(2, 150, 4 * 64, dtype=torch.bfloat16)
    before = run_bd.launches, run_bd.hopper_launches, run_variant.launches
    ab._bd_kernel(fam, q, q, q, 4)
    [(entry, args)] = stub_library.calls
    assert entry == "ud_attention_bd_hopper_fwd" and args[16] == l_from_bf16
    assert (run_bd.launches, run_bd.hopper_launches, run_variant.launches) == (before[0] + 1, before[1] + 1, before[2])


def test_k6_hopper_entry_reads_strided_views_in_place(stub_library):
    """k and v as channel views of one (B, N, 3C) tensor: their row stride
    3C goes to the entry as it is, with no copy."""
    x = torch.zeros(2, 140, 3 * 256, dtype=torch.bfloat16)
    q, k, v = x.split(256, dim=-1)
    ab._ab_kernel("M1", q.contiguous(), k, v, 4)
    [(_, args)] = stub_library.calls
    assert args[1] == k.data_ptr() and args[10:14] == (140 * 768, 768, 140 * 768, 768)


@pytest.mark.parametrize("offset,width,match", [(4, 3 * 256 + 8, "16-byte"), (0, 3 * 256 + 4, "strides")],
                         ids=["unaligned", "strided"])
@pytest.mark.parametrize("kernel", ["k6", "k7"])
def test_ab_hopper_inputs_it_cannot_take_raise_before_the_library(stub_library, kernel, offset, width, match):
    """A view 8 bytes into a row, or a row stride that is not a multiple of
    8, raises before the library; no other body is tried."""
    x = torch.zeros(2, 140, width, dtype=torch.bfloat16)
    k, v = x[..., offset + 256 : offset + 512], x[..., offset + 512 : offset + 768]
    q = torch.zeros(2, 140, 256, dtype=torch.bfloat16)
    before = run_variant.launches, run_bd.launches
    with pytest.raises(ValueError, match=match):
        if kernel == "k6":
            ab._ab_kernel("M1", q, k, v, 4)
        else:
            ab._bd_kernel("M3", q, k, v, 4)
    assert stub_library.calls == [] and (run_variant.launches, run_bd.launches) == before
