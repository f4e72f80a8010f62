"""The port's numpy transforms against the JAX package's PIL ones, on the
CPU with generators of the same seed: uint8 images equal bit for bit;
depth, validity, masks, K, camera_params and paddings exactly equal; each
generator's state after the call equal. ``ContextCrop`` over a sweep of
source shapes, targets and contexts in train and test mode (zoom-outs pad);
the bicubic, bilinear and nearest resizes over a sweep of sizes; the photometric
transforms at their strengths and every branch."""

import copy

import numpy as np
import pytest

from unidepth_tpu.datasets import pipelines as J
from unidepth_tpu_torch.datasets import pipelines as P


def _sample(rng, h, w, extras=False):
    steps = rng.integers(-4, 5, (h, w, 3))
    s = {
        "image": np.clip(np.cumsum(steps, axis=1) + 128, 0, 255).astype(np.uint8),
        "depth": np.where(rng.random((h, w)) < 0.7, rng.uniform(0.5, 60.0, (h, w)), 0.0).astype(np.float32),
        "K": np.asarray([[0.8 * w, 0, w / 2 + 1.3], [0, 0.8 * w, h / 2 - 2.1], [0, 0, 1]], np.float32),
        "validity": rng.random((h, w)) < 0.95,
        "flip": False,
    }
    if extras:
        s["camera_params"] = np.asarray([0.8 * w, 0.8 * w, w / 2, h / 2, 0.1, -0.05, 0.01, 0.002, 0.0, 0.0, 0.0,
                                         0.003, -0.001, 0.0004, 0.0, 0.0], np.float32)
        s["camera_model"] = "OpenCV"
        s["points"] = rng.standard_normal((h, w, 3)).astype(np.float32)
        s["flow_fwd"] = rng.standard_normal((h, w, 2)).astype(np.float32)
        s["flow_fwd_mask"] = rng.random((h, w)) < 0.8
    return s


def _assert_same(got: dict, want: dict):
    assert got.keys() == want.keys(), got.keys() ^ want.keys()
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g == w, k


def _run_both(j_t, p_t, sample, seed, **kw):
    rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
    want = j_t(copy.deepcopy(sample), rj, **kw)
    got = p_t(copy.deepcopy(sample), rp, **kw)
    _assert_same(got, want)
    assert rp.bit_generator.state == rj.bit_generator.state
    return got


@pytest.mark.parametrize("mode", ["bicubic", "bilinear", "nearest"])
def test_resizes_match_pil_over_a_sweep(mode):
    rng = np.random.default_rng({"bicubic": 0, "bilinear": 1, "nearest": 2}[mode])
    for _ in range(60):
        h, w = rng.integers(1, 90, 2)
        th, tw = rng.integers(1, 120, 2)
        for img in (rng.integers(0, 256, (h, w, 3), dtype=np.uint8), rng.integers(0, 256, (h, w), dtype=np.uint8)):
            np.testing.assert_array_equal(P.resize_image(img, (th, tw), mode), J.resize_image(img, (th, tw), mode))
        depth = rng.random((h, w)).astype(np.float32)
        if mode == "nearest":
            np.testing.assert_array_equal(P.resize_depth(depth, (th, tw)), J.resize_depth(depth, (th, tw)))
            flow = rng.random((h, w, 2)).astype(np.float32)
            np.testing.assert_array_equal(P.resize_nearest_nd(flow, (th, tw)), J.resize_nearest_nd(flow, (th, tw)))


def test_nearest_takes_pil_rows_where_the_centre_formula_does_not():
    """The running float64 position (PIL) and floor((i + 0.5) h / th) part
    ways on some size pairs; the port follows PIL."""
    parted = 0
    for h in range(20, 35):
        for th in range(20, 35):
            col = np.arange(h, dtype=np.float32)[:, None]
            got = P.resize_depth(col, (th, 1))[:, 0]
            np.testing.assert_array_equal(got, J.resize_depth(col, (th, 1))[:, 0])
            parted += not np.array_equal(got, np.floor((np.arange(th) + 0.5) * h / th))
    assert parted > 0


@pytest.mark.parametrize("test_mode", [False, True])
def test_context_crop_matches_jax(test_mode):
    rng = np.random.default_rng(3 + test_mode)
    cases = [((60, 80), (28, 42)), ((90, 70), (42, 28)), ((40, 120), (56, 56)), ((33, 47), (14, 70)),
             ((120, 90), (70, 98)), ((25, 25), (42, 28))]
    for i, (src, target) in enumerate(cases):
        for ctx in ((0.6, 1.0, 1.8) if test_mode else (None,)):
            kw = {"image_shape": target, "test_mode": test_mode}
            if test_mode:
                kw["test_context"] = ctx  # >= 1 zooms out: the window pads past the image
            sample = _sample(rng, *src, extras=i % 2 == 1)
            got = _run_both(J.ContextCrop(**kw), P.ContextCrop(**kw), sample, 10 * i)
            assert got["image"].shape[:2] == tuple(target)
            # a per-call shape (the loader's), beside the constructor's
            _run_both(J.ContextCrop(**kw), P.ContextCrop(**kw), sample, 10 * i + 1, image_shape=(28, 28))


def test_context_crop_zoom_out_pads_in_train_mode():
    rng = np.random.default_rng(11)
    sample = _sample(rng, 40, 64)
    kw = {"image_shape": (42, 56), "train_ctx_range": (1.6, 1.9)}
    padded = 0
    for seed in range(6):
        got = _run_both(J.ContextCrop(**kw), P.ContextCrop(**kw), sample, seed)
        padded += any(got["paddings"])
    assert padded


@pytest.mark.parametrize("name", ["RandomFlip", "RandomColorJitter", "RandomGamma", "GaussianBlur",
                                  "RandomGrayscale", "PanoRoll"])
def test_random_transforms_match_jax(name):
    rng = np.random.default_rng(5)
    for seed in range(12):  # each branch: applied or not, strengths across the range
        kw = {"prob": 0.5} if name != "PanoRoll" else {}
        sample = _sample(rng, 37, 61, extras=name == "RandomFlip")
        if name == "RandomFlip":
            sample["paddings"] = (3, 1, 0, 2)
        _run_both(getattr(J, name)(**kw), getattr(P, name)(**kw), sample, seed)


@pytest.mark.parametrize("radius", [0.1, 0.5, 1.0, 1.37, 2.0, 3.5])
def test_gaussian_blur_is_pils_box_blur(radius):
    rng = np.random.default_rng(int(radius * 10))
    img = np.clip(np.cumsum(rng.integers(-9, 10, (41, 67, 3)), axis=0) + 128, 0, 255).astype(np.uint8)
    sample = {"image": img}
    _run_both(J.GaussianBlur(radius=radius, prob=1.0), P.GaussianBlur(radius=radius, prob=1.0), sample, 0)


@pytest.mark.parametrize("strength", [0.0, 0.4, 0.9])
def test_color_jitter_extrapolates_and_clips_as_pil(strength):
    rng = np.random.default_rng(7)
    for seed in range(5):
        sample = {"image": rng.integers(0, 256, (19, 29, 3), dtype=np.uint8)}
        t = dict(strength=strength, prob=1.0)
        _run_both(J.RandomColorJitter(**t), P.RandomColorJitter(**t), sample, seed)


def test_fixed_crops_and_mask_match_jax():
    rng = np.random.default_rng(9)
    sample = _sample(rng, 360, 1230, extras=True)
    _run_both(J.KittiCrop(), P.KittiCrop(), {k: sample[k] for k in ("image", "depth", "K", "validity", "flip")}, 0)
    with pytest.raises(ValueError, match="smaller than crop"):
        P.KittiCrop()(_sample(rng, 300, 1230), rng)
    pano = _sample(rng, 64, 128, extras=True)
    pano["camera_model"] = "Spherical"
    pano["camera_params"] = np.asarray([64.0, 64.0, 64.0, 32.0, 128.0, 64.0, 2 * np.pi, np.pi], np.float32)
    _run_both(J.PanoCrop(), P.PanoCrop(), pano, 0)
    _run_both(J.PanoRoll(test_mode=True), P.PanoRoll(test_mode=True), pano, 0)
    for crop in (None, "garg", "eigen"):
        for max_value in (None, 30.0):
            t = dict(min_value=0.0, max_value=max_value, crop=crop)
            _run_both(J.AnnotationMask(**t), P.AnnotationMask(**t), _sample(rng, 50, 70), 0)


@pytest.mark.parametrize("model", ["OpenCV", "Fisheye624", "MEI", "Spherical", "Pinhole"])
def test_update_camera_params_matches_jax(model):
    rng = np.random.default_rng(13)
    cp = rng.uniform(0.1, 2.0, 16).astype(np.float32) * 50
    for kw in ({"crop": (3, 5, 7, 2)}, {"factor": 0.75}, {"flip_w": 96}, {"crop": (-4, -2, 1, 0), "factor": 1.3}):
        got, want = {"camera_params": cp, "camera_model": model}, {"camera_params": cp, "camera_model": model}
        P.update_camera_params(got, **kw)
        J.update_camera_params(want, **kw)
        np.testing.assert_array_equal(got["camera_params"], want["camera_params"])
