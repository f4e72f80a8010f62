"""The port's small helpers against the JAX package's on seeded numpy inputs
(fp32, CPU): the stacking functions, the pad-aware eval helpers, the
PLY writer and the positional encodings.

Tolerances: the stacking reductions, ``remove_padding`` and the PLY bytes
are exact (the same float32 operations, or formatting of the same values);
``match_gt`` at rtol 1e-5, atol 1e-5 on maps of magnitude ~10 (the two
resizes sum in another order: a few float32 ulps of the inputs, seen up to
2.6e-6); ``ssi_helper``'s sums at rtol 1e-5, atol 1e-6;
``match_intrinsics`` at rtol 1e-6; the RoPE tables bit for bit (float64
arithmetic in numpy on both sides) and ``apply_rope`` and the learned
embedding at rtol 1e-6, atol 1e-6 (the float32 sin/cos of two
libraries)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (sets this process's torch thread count)

from unidepth_tpu.nn import positional as jpos
from unidepth_tpu.utils import misc as jmisc
from unidepth_tpu.utils.visualization import save_point_cloud as jax_save_point_cloud
from unidepth_tpu_torch.nn import positional as tpos
from unidepth_tpu_torch.utils import misc as tmisc
from unidepth_tpu_torch.utils.visualization import save_point_cloud


def _tensors(n, shape=(2, 5, 7, 3), seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * 3.0).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("n", [1, 4], ids=["one", "four"])
@pytest.mark.parametrize("name", ["max", "mean", "first", "last", "softmax", "sum"])
def test_stacking_fns_match_jax(name, n):
    jfn = jmisc.sum_stack if name == "sum" else jmisc.STACKING_FNS[name]
    tfn = tmisc.sum_stack if name == "sum" else tmisc.STACKING_FNS[name]
    xs = _tensors(n)
    got = tfn([torch.from_numpy(x) for x in xs]).numpy()
    want = np.asarray(jfn([jnp.asarray(x) for x in xs]))
    tol = dict(rtol=1e-6, atol=1e-6) if name in ("mean", "softmax") else dict(rtol=0, atol=0)
    np.testing.assert_allclose(got, want, **tol)
    assert set(tmisc.STACKING_FNS) == set(jmisc.STACKING_FNS)


def test_softmax_stack_temperature_matches_jax():
    xs = _tensors(3, seed=1)
    got = tmisc.softmax_stack([torch.from_numpy(x) for x in xs], temperature=0.5).numpy()
    want = np.asarray(jmisc.softmax_stack([jnp.asarray(x) for x in xs], temperature=0.5))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pad", [(0, 0, 0, 0), (2, 2, 1, 1), (3, 0, 0, 2)], ids=["none", "even", "one-sided"])
def test_remove_padding_and_match_gt_match_jax(pad):
    x = _tensors(1, shape=(2, 10, 12, 2), seed=2)[0]
    got = tmisc.remove_padding(torch.from_numpy(x), pad).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmisc.remove_padding(jnp.asarray(x), pad)))
    for gt_shape in ((8, 8), (17, 23)):
        got = tmisc.match_gt(torch.from_numpy(x), gt_shape, padding1=pad).numpy()
        want = np.asarray(jmisc.match_gt(jnp.asarray(x), gt_shape, padding1=pad))
        assert got.shape == (2, *gt_shape, 2)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_match_gt_interior_survives_unpadding():
    """tests/test_utils_extra.py's case: the un-padded interior at its own
    size comes back unchanged."""
    pred = torch.arange(2 * 10 * 12, dtype=torch.float32).reshape(2, 10, 12, 1)
    out = tmisc.match_gt(pred, (8, 8), padding1=(2, 2, 1, 1))
    torch.testing.assert_close(out, tmisc.remove_padding(pred, (2, 2, 1, 1)), rtol=0, atol=1e-4)


@pytest.mark.parametrize("pad", [(0, 0, 0, 0), (2, 2, 1, 1), (3, 1, 4, 0)], ids=["none", "even", "uneven"])
def test_match_intrinsics_matches_jax(pad):
    K = np.array([[[100.0, 0, 6.0], [0, 100.0, 5.0], [0, 0, 1]], [[80.0, 0.5, 30.0], [0, 90.0, 20.0], [0, 0, 1]]],
                 np.float32)
    Kt = torch.from_numpy(K.copy())
    got = tmisc.match_intrinsics(Kt, (10, 12), (16, 17), padding1=pad).numpy()
    want = np.asarray(jmisc.match_intrinsics(jnp.asarray(K), (10, 12), (16, 17), padding1=pad))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(Kt.numpy(), K)  # the input is left as it was
    if pad == (2, 2, 1, 1):  # tests/test_utils_extra.py's expectations, at 16 x 16
        K2 = tmisc.match_intrinsics(torch.from_numpy(K[:1]), (10, 12), (16, 16), padding1=pad)
        assert float(K2[0, 0, 2]) == (6.0 - 2) * 2.0 and float(K2[0, 1, 2]) == (5.0 - 1) * 2.0
        assert float(K2[0, 0, 0]) == 100.0 * 2.0


def test_ssi_helper_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.uniform(0.5, 5.0, (3, 40)).astype(np.float32)
    target = (2.5 * x + 0.7 + 0.01 * rng.standard_normal(x.shape)).astype(np.float32)
    got = tmisc.ssi_helper(torch.from_numpy(x), torch.from_numpy(target))
    want = jmisc.ssi_helper(jnp.asarray(x), jnp.asarray(target))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("colors", [False, True], ids=["points", "coloured"])
def test_save_point_cloud_bytes_match_jax(tmp_path, colors):
    """Byte for byte the JAX writer's file, across a chunk boundary, with
    signed zeros, ties of the 5th decimal, large and non-finite values."""
    rng = np.random.default_rng(4)
    n = (1 << 16) + 37
    pts = (rng.standard_normal((n, 3)) * np.array([1e-5, 3.0, 2e3])).astype(np.float32)
    pts[:4] = np.array([[-0.0, 0.0, np.nan], [np.inf, -np.inf, -1e-7], [0.000005, -0.000015, 0.125],
                        [1e30, -3.4e38, 12345.678]], np.float32)
    cols = rng.integers(0, 256, (n, 3), dtype=np.uint8) if colors else None
    save_point_cloud(tmp_path / "t.ply", pts, cols)
    jax_save_point_cloud(str(tmp_path / "j.ply"), pts, cols)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_rope_tables_and_apply_match_jax():
    cos_t, sin_t = tpos.rope_2d_tables(3, 5, 16)
    cos_j, sin_j = jpos.rope_2d_tables(3, 5, 16)
    assert cos_t.dtype == torch.float32 and cos_t.shape == (15, 16)
    np.testing.assert_array_equal(cos_t.numpy(), np.asarray(cos_j))
    np.testing.assert_array_equal(sin_t.numpy(), np.asarray(sin_j))
    x = np.random.default_rng(5).standard_normal((2, 4, 15, 16)).astype(np.float32)
    got = tpos.apply_rope(torch.from_numpy(x), cos_t, sin_t).numpy()
    want = np.asarray(jpos.apply_rope(jnp.asarray(x), cos_j, sin_j))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tpos._rotate_half(torch.arange(4.0)).numpy(), [-1.0, 0.0, -3.0, 2.0])


def test_learned_sinusoidal_pos_emb_matches_jax():
    """The flax module's ``weights`` carried into the torch module."""
    x = np.random.default_rng(6).uniform(0, 10, (7,)).astype(np.float32)
    jm = jpos.LearnedSinusoidalPosEmb(dim=16)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = tpos.LearnedSinusoidalPosEmb(16)
    assert tuple(tm.weights.shape) == (8,)
    tm.load_state_dict({"weights": torch.from_numpy(np.array(params["params"]["weights"]))})
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    assert got.shape == (7, 17)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        tpos.LearnedSinusoidalPosEmb(15)
