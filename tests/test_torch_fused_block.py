"""Plain version of the port's ln_dense kernel (K2) against the JAX package:
the XLA formulation ``_xla_ln_dense`` (exact erf GELU) at atol 1e-5, and the
Pallas ``ln_dense`` run in interpret mode on the CPU (A&S erf, measured
2.9e-6 from the exact erf) at atol 3e-5. fp32, eps 1e-6 (ViT) and 1e-5
(decoder ConvNeXt blocks)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (sets this process's torch thread count)

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


class _EntryRecorder:
    """A stand-in for the kernel library: records which C entries were
    called and reports success."""

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


HOPPER = ["ud_ln_row_stats", "ud_ln_dense_hopper_fwd"]
OLD = ["ud_ln_dense_fwd"]


def _zeros(dtype, m, c, f, offset=0):
    """x (2, m/2, c), weight (f, c), bias (f,), gamma and beta (c,); x starts
    ``offset`` bytes into its storage."""
    flat = torch.zeros(m * c + 16, dtype=dtype)
    skip = offset // flat.element_size()
    x = flat[skip : skip + m * c].view(2, m // 2, c)
    return x, torch.zeros(f, c, dtype=dtype), torch.zeros(f), torch.ones(c), torch.zeros(c)


@pytest.mark.parametrize(
    "dtype,c,f,entries",
    [
        (torch.bfloat16, 128, 256, HOPPER),
        (torch.bfloat16, 1024, 4096, HOPPER),  # the ViT-L block
        (torch.bfloat16, 192, 768, HOPPER),  # ConvNeXt's narrowest C, F = 4C
        (torch.float32, 128, 256, OLD),
        (torch.bfloat16, 96, 384, OLD),  # C % 64 != 0
        (torch.bfloat16, 128, 384, OLD),  # F % 256 != 0
        (torch.bfloat16, 2112, 256, OLD),  # C > 2048: gamma and beta would not fit beside the ring
    ],
    ids=["bf16-hopper", "bf16-vitl", "bf16-convnext", "fp32", "bf16-c96", "bf16-f384", "bf16-c2112"],
)
def test_k2_routes_by_dtype_and_shape(stub_library, dtype, c, f, entries):
    """bf16 on the Hopper gate launches the row statistics, then the wgmma
    GEMM (one call, one count); fp32 and off-gate shapes take ln_dense.cu."""
    from unidepth_tpu_torch.ops import fused_block as fb

    args = _zeros(dtype, 6, c, f)
    before = fb.ln_dense.launches, fb.ln_dense.hopper_launches
    out = fb._ln_dense_kernel(*args, 1e-6, "gelu")
    assert out.shape == (2, 3, f) and out.dtype == dtype
    assert stub_library.calls == entries
    after = fb.ln_dense.launches, fb.ln_dense.hopper_launches
    assert after == (before[0] + 1, before[1] + (entries == HOPPER))


@pytest.mark.parametrize("dtype,c,f", [(torch.bfloat16, 128, 256), (torch.float32, 128, 256), (torch.bfloat16, 96, 384)])
def test_k2_misaligned_view_raises_before_the_library(stub_library, dtype, c, f):
    """x 8 bytes into its storage: both bodies load rows 16 bytes at a
    time, so the wrapper raises and calls no entry."""
    from unidepth_tpu_torch.ops import fused_block as fb

    args = _zeros(dtype, 6, c, f, offset=8)
    assert args[0].is_contiguous() and args[0].data_ptr() % 16 == 8
    before = fb.ln_dense.launches, fb.ln_dense.hopper_launches
    with pytest.raises(ValueError, match="16-byte"):
        fb._ln_dense_kernel(*args, 1e-6, "gelu")
    assert stub_library.calls == []
    assert (fb.ln_dense.launches, fb.ln_dense.hopper_launches) == before


@pytest.mark.parametrize("dtype,c,f", [(torch.float32, 48, 256), (torch.bfloat16, 128, 320)])
def test_k2_raises_off_every_gate(stub_library, dtype, c, f):
    from unidepth_tpu_torch.ops import fused_block as fb

    with pytest.raises(ValueError, match="C % 32"):
        fb._ln_dense_kernel(*_zeros(dtype, 6, c, f), 1e-6, None)
    assert stub_library.calls == []
