"""The port's last transforms (``Rotate``, the ``ImageEnhance`` and
``ImageOps`` ones, ``RandomColor``, ``RandomShear``, ``RandomTranslate``,
``Normalize``, ``RandomMasking``, ``RandomFiller``) and
``masked_nearest_fill`` against the JAX package's, on the CPU with
generators of the same seed: every key of the sample equal bit for bit
(uint8 images, float32 depth and ``image_norm``, bool validity, K, the
rotation) and each generator's state after the call equal. No tolerance:
the affine ones call Pillow as JAX does, the others are numpy copies of
Pillow's arithmetic. Both probability branches, scalar and range levels,
both shear and shift directions, odd sizes and a KITTI-aspect frame, and
every ``RandomFiller`` mode on a validity with holes; then one sample
through all sixteen and both packages' ``collate`` (arrays exact, rays
within 1e-6, as tests/test_torch_loader.py holds them). The HSV
conversions under ``RandomColor`` are held to Pillow's over every 8-bit
triple."""

import copy

import numpy as np
import pytest
from PIL import Image

from unidepth_tpu.datasets import pipelines as J
from unidepth_tpu.datasets.loader import collate as j_collate
from unidepth_tpu_torch.datasets import pipelines as P
from unidepth_tpu_torch.datasets.loader import collate as p_collate

SHAPES = [(37, 61), (47, 155)]  # odd sizes; the second at KITTI's aspect (375 x 1242)
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _sample(rng, h, w):
    steps = rng.integers(-6, 7, (h, w, 3))
    validity = np.ones((h, w), bool)
    validity[rng.integers(0, h, 6), rng.integers(0, w, 6)] = False  # holes
    validity[: h // 5, : w // 4] = False
    return {
        "image": np.clip(np.cumsum(steps, axis=1) + rng.integers(60, 200, (1, 1, 3)), 0, 255).astype(np.uint8),
        "depth": np.where(validity, rng.uniform(0.5, 60.0, (h, w)), 0.0).astype(np.float32),
        "K": np.asarray([[0.8 * w, 0, w / 2 + 1.3], [0, 0.8 * w, h / 2 - 2.1], [0, 0, 1]], np.float32),
        "validity": validity,
        "flip": False,
    }


def _assert_same(got: dict, want: dict):
    assert got.keys() == want.keys(), got.keys() ^ want.keys()
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g == w, k


def _run_both(name, kw, sample, seed):
    rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
    want = getattr(J, name)(**kw)(copy.deepcopy(sample), rj)
    got = getattr(P, name)(**kw)(copy.deepcopy(sample), rp)
    _assert_same(got, want)
    assert rp.bit_generator.state == rj.bit_generator.state
    return got, sample


# (transform, keyword cases); each case runs at prob 0.5 over seeds, so both
# branches run, and at prob 1
CASES = {
    "Rotate": [{"angle": 5.0}, {"angle": (-30.0, 30.0)}, {"angle": 90.0}],
    "RandomSaturation": [{"level": (-0.5, 0.5)}, {"level": 1.5}, {"level": -2.0}],
    "RandomSharpness": [{"level": (-0.5, 0.5)}, {"level": 1.5}, {"level": -2.0}],
    "RandomBrightness": [{"level": (-0.5, 0.5)}, {"level": 1.0}, {"level": -1.0}],
    "RandomContrast": [{"level": (-0.5, 0.5)}, {"level": 1.0}, {"level": -3.0}],
    "RandomColor": [{"level": (-0.05, 0.05)}, {"level": 0.3}, {"level": -0.5}],
    "RandomInvert": [{}],
    "RandomAutoContrast": [{}],
    "RandomShear": [{"magnitude": (-0.2, 0.2)}, {"magnitude": 0.3, "horizontal": False},
                    {"magnitude": (-0.4, 0.1), "horizontal": False}, {"magnitude": 0.25}],
    "RandomTranslate": [{"magnitude": (-0.1, 0.1)}, {"magnitude": 0.3, "horizontal": False},
                        {"magnitude": (-0.45, 0.45), "horizontal": False}, {"magnitude": 0.2}],
    "RandomSolarize": [{}, {"threshold": 64}],
    "RandomPosterize": [{}, {"bits": 1}, {"bits": 7}],
    "RandomEqualize": [{}],
    "RandomMasking": [{}, {"mask_ratio": 0.3, "patch": 8}],
}


@pytest.mark.parametrize("name", list(CASES))
def test_transform_matches_jax(name):
    rng = np.random.default_rng(sorted(CASES).index(name))
    applied = 0
    for i, kw in enumerate(CASES[name]):
        for h, w in SHAPES:
            sample = _sample(rng, h, w)
            for seed in range(6):
                got, before = _run_both(name, {**kw, "prob": 0.5}, sample, 100 * i + seed)
                applied += not np.array_equal(got["image"], before["image"])
            _run_both(name, {**kw, "prob": 1.0}, sample, 7 * i)
    assert applied  # prob 0.5 took the transform at least once (and skipped it at least once)
    assert applied < 6 * len(CASES[name]) * len(SHAPES)


def test_geometric_transforms_zero_the_borders_they_bring_in():
    rng = np.random.default_rng(11)
    sample = _sample(rng, 47, 155)
    sample["validity"][:] = True
    sample["depth"] = np.full((47, 155), 3.0, np.float32)
    for name, kw in (("Rotate", {"angle": 20.0}), ("RandomShear", {"magnitude": 0.3}),
                     ("RandomTranslate", {"magnitude": 0.2, "horizontal": False})):
        got, _ = _run_both(name, {**kw, "prob": 1.0}, sample, 3)
        assert not got["validity"].all() and (got["depth"][~got["validity"]] == 0).all(), name
    got, _ = _run_both("Rotate", {"angle": 20.0, "prob": 1.0}, sample, 3)
    assert abs(got["rotation"]) == 20.0


@pytest.mark.parametrize("modes", [("noise",), ("black",), ("white",), ("noise", "black", "white")])
def test_random_filler_matches_jax(modes):
    rng = np.random.default_rng(len(modes) + sum(map(len, modes)))
    for h, w in SHAPES:
        sample = _sample(rng, h, w)
        for seed in range(4):
            got, _ = _run_both("RandomFiller", {"modes": modes}, sample, seed)
            assert not np.array_equal(got["image"][~sample["validity"]], sample["image"][~sample["validity"]])
        whole = {**sample, "validity": np.ones((h, w), bool)}  # nothing to fill: no draw
        _run_both("RandomFiller", {"modes": modes}, whole, 0)


def test_normalize_matches_jax():
    rng = np.random.default_rng(5)
    for h, w in SHAPES:
        got, sample = _run_both("Normalize", {"mean": MEAN, "std": STD}, _sample(rng, h, w), 0)
        assert got["image_norm"].dtype == np.float32 and got["image"] is not None
        np.testing.assert_array_equal(got["image"], sample["image"])


@pytest.mark.parametrize("iters", [1, 2, 5])
def test_masked_nearest_fill_matches_jax(iters):
    rng = np.random.default_rng(iters)
    for h, w in SHAPES:
        s = _sample(rng, h, w)
        np.testing.assert_array_equal(P.masked_nearest_fill(s["depth"], s["validity"], iters),
                                      J.masked_nearest_fill(s["depth"], s["validity"], iters))
    full = np.ones((5, 5), bool)  # nothing to fill: the depth as it was
    np.testing.assert_array_equal(P.masked_nearest_fill(s["depth"][:5, :5], full, iters), s["depth"][:5, :5])


def _all_sixteen(module):
    return module.Compose([
        module.Rotate(angle=(-10.0, 10.0), prob=1.0), module.RandomSaturation(prob=1.0),
        module.RandomSharpness(prob=1.0), module.RandomBrightness(prob=1.0), module.RandomContrast(prob=1.0),
        module.RandomColor(prob=1.0), module.RandomInvert(prob=1.0), module.RandomAutoContrast(prob=1.0),
        module.RandomShear(prob=1.0), module.RandomTranslate(prob=1.0, horizontal=False),
        module.RandomSolarize(prob=1.0), module.RandomPosterize(prob=1.0), module.RandomEqualize(prob=1.0),
        module.RandomMasking(prob=1.0, patch=8), module.RandomFiller(), module.Normalize(MEAN, STD),
    ])


def test_all_sixteen_then_collate_match_jax():
    rng = np.random.default_rng(21)
    samples = [_sample(rng, 42, 140) for _ in range(3)]
    rj, rp = np.random.default_rng(4), np.random.default_rng(4)
    want = [_all_sixteen(J)(copy.deepcopy(s), rj) for s in samples]
    got = [_all_sixteen(P)(copy.deepcopy(s), rp) for s in samples]
    for g, w in zip(got, want):
        _assert_same(g, w)
    assert rp.bit_generator.state == rj.bit_generator.state
    bj, bp = j_collate(want), p_collate(got)
    assert bp.keys() == bj.keys()
    for k in bj:
        if k == "rays":
            np.testing.assert_allclose(bp[k], np.asarray(bj[k]), atol=1e-6, rtol=0)
        else:
            np.testing.assert_array_equal(bp[k], np.asarray(bj[k]), err_msg=k)
    assert (bp["validity_mask"] == 0).any()


def test_hsv_conversions_match_pillow_over_every_triple():
    low = np.arange(2**16, dtype=np.uint32)
    for first in range(0, 256, 16):  # 16 blocks of 2^20 triples each
        c = (np.arange(first, first + 16, dtype=np.uint32)[:, None] << 16 | low).ravel()
        img = np.stack([c >> 16, (c >> 8) & 255, c & 255], -1).astype(np.uint8).reshape(1024, 1024, 3)
        np.testing.assert_array_equal(P._rgb_to_hsv(img), np.asarray(Image.fromarray(img).convert("HSV")))
        np.testing.assert_array_equal(P._hsv_to_rgb(img), np.asarray(Image.fromarray(img, "HSV").convert("RGB")))


def test_affine_transforms_name_pillow_when_it_is_missing(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    sample = _sample(np.random.default_rng(0), 20, 30)
    for t in (P.Rotate(prob=1.0), P.RandomShear(prob=1.0), P.RandomTranslate(prob=1.0)):
        with pytest.raises(ImportError, match="Pillow"):
            t(copy.deepcopy(sample), np.random.default_rng(0))
    P.RandomColor(prob=1.0)(copy.deepcopy(sample), np.random.default_rng(0))  # numpy: no Pillow needed
