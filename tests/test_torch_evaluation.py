"""The port's evaluation metrics and nearest-neighbour ops against the JAX
package on seeded inputs (fp32, CPU), and the kNN ops against a float64
brute force.

Gates. On the same depth maps the metric code alone is held at rtol 1e-5
(atol 1e-6 near 0): every metric of ``eval_depth``, with and without
``max_depth``. With a prediction on another grid both packages resize it
first (F.interpolate here, resampling matrices in JAX, ~1e-7 apart), so a
pixel whose ratio sits on a threshold may flip: the metrics that count
pixels (d1/d2/d3, tau and their rescaled variants, d_auc) are allowed one
pixel a sample (1 / n_valid), the continuous ones rtol 1e-4. The kNN
squared distances at atol 1e-5 against float64 and against JAX: the matmul
form ||x||^2 + ||y||^2 - 2 x.y cancels in float32 (~4e-6 on clouds at
|x|^2 ~ 10), in an order that differs between the packages; a neighbour
index may differ only on a tie within that. ``eval_3d``'s Chamfer distance,
a mean of the square roots of those squared distances, at rtol 1e-4, and
its F1 within one threshold's step (1 / T).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (sets this process's torch thread count)

from unidepth_tpu.ops import knn as jknn
from unidepth_tpu.utils import evaluation as jeval
from unidepth_tpu.utils.validation import MetricAccumulator as JMetricAccumulator
from unidepth_tpu_torch.ops import knn as tknn
from unidepth_tpu_torch.utils import evaluation as teval
from unidepth_tpu_torch.utils.validation import MetricAccumulator

COUNTING = ("d1", "d2", "d3", "tau", "d_auc", "d1_ssi", "tau_ssi", "d1_si", "tau_si")


def _depth_maps(b=3, h=20, w=26, pred_hw=None, seed=0):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0.3, 12.0, (b, h, w, 1)).astype(np.float32)
    ph, pw = pred_hw or (h, w)
    base = gt if pred_hw is None else rng.uniform(0.3, 12.0, (b, ph, pw, 1)).astype(np.float32)
    pred = (base * rng.lognormal(0.0, 0.3, (b, ph, pw, 1))).astype(np.float32)
    mask = rng.random((b, h, w, 1)) < 0.8
    mask[0, :3] = False
    gt[1, 0, :5] = 0.0  # invalid GT inside the mask
    return gt, pred, mask


@pytest.mark.parametrize("max_depth", [None, 8.0])
def test_eval_depth_matches_jax_on_the_same_maps(max_depth):
    gt, pred, mask = _depth_maps()
    got = teval.eval_depth(torch.from_numpy(gt), torch.from_numpy(pred), torch.from_numpy(mask), max_depth=max_depth)
    want = jeval.eval_depth(jnp.asarray(gt), jnp.asarray(pred), jnp.asarray(mask), max_depth=max_depth)
    assert set(got) == set(want) == set(teval.DEPTH_METRICS)
    for k in teval.DEPTH_METRICS:
        assert got[k].shape == (3,)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)


def test_eval_depth_resizes_the_prediction_like_jax():
    gt, pred, mask = _depth_maps(pred_hw=(10, 13))
    got = teval.eval_depth(torch.from_numpy(gt), torch.from_numpy(pred), torch.from_numpy(mask), max_depth=10.0)
    want = jeval.eval_depth(jnp.asarray(gt), jnp.asarray(pred), jnp.asarray(mask), max_depth=10.0)
    n_valid = ((mask & (gt > 0) & (gt <= 10.0)).reshape(3, -1).sum(-1)).astype(np.float64)
    for k in teval.DEPTH_METRICS:
        if k in COUNTING:
            assert np.all(np.abs(got[k].numpy() - np.asarray(want[k])) <= 1.0 / n_valid + 1e-6), k
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-6, err_msg=k)


def test_perfect_prediction():
    gt, _, mask = _depth_maps()
    m = teval.eval_depth(torch.from_numpy(gt), torch.from_numpy(gt), torch.from_numpy(mask))
    for k in ("d1", "d2", "d3", "tau", "d1_ssi", "d1_si"):
        np.testing.assert_allclose(m[k].numpy(), 1.0, err_msg=k)
    for k in ("rmse", "arel", "sqrel", "log10", "silog", "medianlog"):
        np.testing.assert_allclose(m[k].numpy(), 0.0, atol=1e-5, err_msg=k)


def _clouds(b=2, p=2600, seed=1):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-1, 1, (b, p, 3)).astype(np.float32)
    gt[..., 2] += 3.0
    pred = (gt + rng.normal(0, 0.02, gt.shape)).astype(np.float32)
    mask = rng.random((b, p)) < 0.9
    return gt, pred, mask


def test_eval_3d_matches_jax():
    gt, pred, mask = _clouds()
    thr = np.exp(np.linspace(np.log(1e-4), np.log(0.05), 100)).astype(np.float32)
    shape = (2, 50, 52)
    args_t = (torch.from_numpy(gt.reshape(*shape, 3)), torch.from_numpy(pred.reshape(*shape, 3)),
              torch.from_numpy(mask.reshape(*shape, 1)))
    got = teval.eval_3d(*args_t, torch.from_numpy(thr))
    want = jeval.eval_3d(*(jnp.asarray(a.numpy()) for a in args_t), jnp.asarray(thr))
    np.testing.assert_allclose(got["chamfer"].numpy(), np.asarray(want["chamfer"]), rtol=1e-4)
    np.testing.assert_allclose(got["F1"].numpy(), np.asarray(want["F1"]), rtol=0, atol=1.0 / len(thr))
    same = teval.eval_3d(args_t[0], args_t[0], args_t[2], torch.from_numpy(thr))
    # a perfect prediction: the matmul form leaves each squared distance at
    # the float32 cancellation of |x|^2 (a few ulp), so the Chamfer distance
    # is ~sqrt(eps32) |x|, not 0, in JAX too; F1 is 1 at every threshold,
    # and the trapezoid of 100 ones with dx = 1, over 100, is 0.99
    bound = np.sqrt(8 * np.finfo(np.float32).eps) * np.linalg.norm(gt, axis=-1).max()
    assert np.all(same["chamfer"].numpy() <= bound), (same["chamfer"], bound)
    np.testing.assert_allclose(same["F1"].numpy(), 0.99, rtol=1e-6)


def _brute(x, y, y_valid):
    d = ((x[:, None, :].astype(np.float64) - y[None].astype(np.float64)) ** 2).sum(-1)
    d[:, ~y_valid] = np.inf
    return d


@pytest.mark.parametrize("n_valid_ref", [None, 2])
def test_nn_distances_and_chamfer(n_valid_ref):
    """2600 queries cross a 2048 chunk; ``n_valid_ref`` = 2 is the underfull
    cloud (almost every reference invalid)."""
    gt, pred, mask = _clouds(b=1)
    x, y, xv = gt[0], pred[0, :2100], mask[0]
    yv = np.ones(len(y), bool) if n_valid_ref is None else np.arange(len(y)) < n_valid_ref
    d2, idx = tknn.nn_distances(*(torch.from_numpy(a) for a in (x, y, xv, yv)))
    jd2, jidx = jknn.nn_distances(*(jnp.asarray(a) for a in (x, y, xv, yv)))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=1e-5, atol=1e-5)
    brute = _brute(x, y, yv)
    np.testing.assert_allclose(d2.numpy(), np.where(xv, brute.min(-1), 0.0), rtol=0, atol=1e-5)
    picked = brute[np.arange(len(x)), idx.numpy()]
    np.testing.assert_allclose(picked, brute.min(-1), rtol=0, atol=1e-5)
    assert (idx.numpy() == np.asarray(jidx)).mean() > 0.99
    d_xy, d_yx = tknn.chamfer_distance(*(torch.from_numpy(a) for a in (x, y, xv, yv)))
    jd_xy, jd_yx = jknn.chamfer_distance(*(jnp.asarray(a) for a in (x, y, xv, yv)))
    np.testing.assert_allclose(d_xy.numpy(), np.asarray(jd_xy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d_yx.numpy(), np.asarray(jd_yx), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("underfull", [False, True])
def test_knn_points_and_gather(k, underfull):
    """Batched kNN; ``underfull``: the second cloud has 2 valid references,
    fewer than K = 3, and the missing neighbours come back as 0."""
    rng = np.random.default_rng(k)
    x = rng.uniform(-1, 1, (2, 300, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (2, 400, 3)).astype(np.float32)
    xv = rng.random((2, 300)) < 0.9
    yv = np.ones((2, 400), bool)
    if underfull:
        yv[1] = np.arange(400) < 2
    d2, idx = tknn.knn_points(*(torch.from_numpy(a) for a in (x, y, xv, yv)), k=k)
    jd2, jidx = jknn.knn_points(*(jnp.asarray(a) for a in (x, y, xv, yv)), k=k)
    assert d2.shape == idx.shape == (2, 300, k)
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    for b in range(2):
        brute = np.sort(_brute(x[b], y[b], yv[b]), axis=-1)[:, :k]
        want = np.where(np.isfinite(brute) & xv[b][:, None], brute, 0.0)
        np.testing.assert_allclose(d2[b].numpy(), want, rtol=0, atol=1e-5)
    gathered = tknn.knn_gather(torch.from_numpy(y), idx)
    np.testing.assert_array_equal(gathered.numpy(), np.asarray(jknn.knn_gather(jnp.asarray(y), jidx)))
    assert gathered.shape == (2, 300, k, 3)


def test_metric_accumulator_with_pad_mask():
    gt, pred, mask = _depth_maps(b=4)
    pad = np.array([True, True, False, True])
    pts = _clouds(b=4, p=20 * 26)
    thr = np.exp(np.linspace(np.log(1e-3), np.log(0.5), 100)).astype(np.float32)
    acc, jacc = MetricAccumulator("x", max_depth=9.0), JMetricAccumulator("x", max_depth=9.0)
    for sl in (slice(0, 2), slice(2, 4)):
        p3 = [a[sl].reshape(-1, 20, 26, 3) for a in pts[:2]]
        acc.accumulate(*(torch.from_numpy(a[sl]) for a in (gt, pred, mask)), points_gt=torch.from_numpy(p3[0]),
                       points_pred=torch.from_numpy(p3[1]), thresholds=torch.from_numpy(thr), sample_mask=pad[sl])
        jacc.accumulate(*(jnp.asarray(a[sl]) for a in (gt, pred, mask)), points_gt=jnp.asarray(p3[0]),
                        points_pred=jnp.asarray(p3[1]), thresholds=jnp.asarray(thr), sample_mask=pad[sl])
    got, want = acc.get_evaluation(), jacc.get_evaluation()
    assert set(got) == set(want) == {*teval.DEPTH_METRICS, "chamfer", "F1"}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6 if k != "F1" else 1.0 / 100, err_msg=k)
    # the padded sample is dropped: the mean of the three real ones
    only = teval.eval_depth(*(torch.from_numpy(a[pad]) for a in (gt, pred, mask)), max_depth=9.0)
    np.testing.assert_allclose(got["arel"], only["arel"].double().mean().item(), rtol=1e-6)
    assert acc.get_evaluation() == {}  # cleared
