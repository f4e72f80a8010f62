"""The port's training losses (``unidepth_tpu_torch/training/losses.py``) and
``ops/patches.py`` against the JAX package on seeded inputs, fp32 on the
CPU: each loss's per-sample values, and the gradient of a weighted sum of
them with respect to the prediction, at rtol 1e-5 (with an absolute floor of
1e-5 x max |ref| for the gradients, whose near-zero entries are sums that
cancel). Maps are 42 x 56: the 1/14 grid is 3 x 4, and no token centre
falls on the principal point."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (sets this process's torch thread count)

from unidepth_tpu.ops.patches import bilinear_sample as j_bilinear_sample
from unidepth_tpu.ops.patches import extract_patches as j_extract_patches
from unidepth_tpu.training import losses as jl
from unidepth_tpu_torch.ops.patches import bilinear_sample, extract_patches
from unidepth_tpu_torch.training import losses as tl

B, H, W = 4, 42, 56
RTOL = 1e-5


def _data(seed=0):
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=(B, H, W, 1)) > 0.2
    validity = (rng.uniform(size=(B, H, W, 1)) > 0.05).astype(np.float32)
    K = np.stack([np.array([[0.7 * W * s, 0, W / 2 + d], [0, 0.7 * W * s, H / 2 - d], [0, 0, 1]], np.float32)
                  for s, d in ((1.0, 0.0), (1.1, 1.5), (0.9, -2.0), (1.0, 0.5))])
    return {
        "pred": rng.uniform(0.3, 8.0, (B, H, W, 1)).astype(np.float32),
        "gt": rng.uniform(0.3, 8.0, (B, H, W, 1)).astype(np.float32),
        "mask": mask,
        "validity": validity,
        "image": rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32),
        "K": K,
        "si": np.array([0.0, 1.0, 0.0, 0.0], np.float32),
        "rays": rng.standard_normal((B, H * W, 3)).astype(np.float32),
        "rays_gt": rng.standard_normal((B, H * W, 3)).astype(np.float32),
        "logconf": rng.normal(0.0, 0.5, (B, H, W, 1)).astype(np.float32),
        "weights": rng.uniform(0.5, 1.5, B).astype(np.float32),
    }


def _value_and_grad(j_fn, t_fn, inputs, weights):
    """Per-sample values of both packages' losses and their gradients of
    sum(weights * loss) with respect to ``inputs``."""
    vg = jax.jit(jax.value_and_grad(lambda *a: jnp.sum(j_fn(*a) * weights), argnums=tuple(range(len(inputs))),
                                    has_aux=False))
    j_val = jax.jit(j_fn)(*map(jnp.asarray, inputs))
    _, j_grads = vg(*map(jnp.asarray, inputs))
    t_in = [torch.from_numpy(a).requires_grad_() for a in inputs]
    t_val = t_fn(*t_in)
    t_grads = torch.autograd.grad((t_val * torch.from_numpy(weights)).sum(), t_in)
    np.testing.assert_allclose(t_val.detach().numpy(), np.asarray(j_val), rtol=RTOL, atol=0)
    for tg, jg in zip(t_grads, j_grads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(tg.numpy(), jg, rtol=RTOL, atol=RTOL * np.abs(jg).max())


def _pair(name, cfg):
    return jl.LOSS_REGISTRY[name].build(cfg), tl.LOSS_REGISTRY[name].build(cfg)


def test_registry_and_build_losses_match():
    assert set(tl.LOSS_REGISTRY) == set(jl.LOSS_REGISTRY)
    import json
    from pathlib import Path

    cfg = json.loads((Path(__file__).resolve().parents[1] / "configs/config_v2_vitl14.json").read_text())
    j, t = jl.build_losses(cfg), tl.build_losses(cfg)
    assert list(j) == list(t)
    for slot in j:
        assert type(j[slot]).__name__ == type(t[slot]).__name__
        fields = j[slot].__dataclass_fields__
        assert {f: getattr(t[slot], f) for f in fields} == {f: getattr(j[slot], f) for f in fields}


def test_silog():
    d = _data(1)
    jloss, tloss = _pair("SILog", {"weight": 1.0, "integrated": 0.15})
    _value_and_grad(lambda p: jloss(p, jnp.asarray(d["gt"]), jnp.asarray(d["mask"]), si=jnp.asarray(d["si"])),
                    lambda p: tloss(p, torch.from_numpy(d["gt"]), torch.from_numpy(d["mask"]), si=torch.from_numpy(d["si"])),
                    [d["pred"]], d["weights"])


@pytest.mark.parametrize("fn", ["l2", "l1", "charbonnier", "cauchy", "geman_mcclure", "robust_loss"])
def test_regression(fn):
    d = _data(2)
    jloss, tloss = _pair("Regression", {"weight": 0.25, "fn": fn, "gamma": 1.3, "alpha": 0.7})
    _value_and_grad(lambda p: jloss(p, jnp.asarray(d["rays_gt"])), lambda p: tloss(p, torch.from_numpy(d["rays_gt"])),
                    [d["rays"]], d["weights"])


def test_confidence_gradients_of_confidence_and_depth():
    """Both the confidence input and the depth prediction (through the
    masked-median rescale) carry gradients; one sample has an empty mask."""
    d = _data(3)
    mask = d["mask"].copy()
    mask[2] = False
    jloss, tloss = _pair("Confidence", {"weight": 0.1})
    _value_and_grad(lambda c, p: jloss(c, target_pred=p, target_gt=jnp.asarray(d["gt"]), mask=jnp.asarray(mask)),
                    lambda c, p: tloss(c, target_pred=p, target_gt=torch.from_numpy(d["gt"]), mask=torch.from_numpy(mask)),
                    [d["logconf"], d["pred"]], d["weights"])


@pytest.mark.parametrize("flips", [(False, False, False, False), (False, True, True, True)], ids=["no-flip", "flips"])
def test_self_distill(flips):
    d = _data(4)
    flips = np.array(flips)
    jloss, tloss = _pair("SelfDistill", {"weight": 0.1})
    _value_and_grad(
        lambda p: jloss(p, intrinsics=jnp.asarray(d["K"]), mask=jnp.asarray(d["mask"]), flips=jnp.asarray(flips)),
        lambda p: tloss(p, intrinsics=torch.from_numpy(d["K"]), mask=torch.from_numpy(d["mask"]), flips=torch.from_numpy(flips)),
        [d["pred"]], d["weights"])


def test_self_distill_on_features_with_a_resized_mask():
    """V1's use: 1/14-scale features, the mask nearest-resized onto them."""
    d = _data(5)
    feats = np.random.default_rng(5).standard_normal((B, H // 14, W // 14, 8)).astype(np.float32)
    flips = np.array([False, True, False, False])
    jloss, tloss = _pair("SelfDistill", {"weight": 0.1})
    _value_and_grad(
        lambda p: jloss(p, intrinsics=jnp.asarray(d["K"]), mask=jnp.asarray(d["mask"]), flips=jnp.asarray(flips),
                        downsample_ratio=14),
        lambda p: tloss(p, intrinsics=torch.from_numpy(d["K"]), mask=torch.from_numpy(d["mask"]),
                        flips=torch.from_numpy(flips), downsample_ratio=14),
        [feats], d["weights"])


@pytest.mark.parametrize("patch_size", [(0.25, 0.75), (8, 24)], ids=["fractional", "pixels"])
def test_local_ssi_without_rng(patch_size):
    d = _data(6)
    cfg = {"weight": 1.0, "patch_size": patch_size, "min_samples": 4, "num_levels": 3}
    jloss, tloss = _pair("LocalSSI", cfg)
    _value_and_grad(lambda p: jloss(p, jnp.asarray(d["gt"]), jnp.asarray(d["mask"])),
                    lambda p: tloss(p, torch.from_numpy(d["gt"]), torch.from_numpy(d["mask"])),
                    [d["pred"]], d["weights"])


def test_local_ssi_rng_draws_from_the_same_buckets():
    """With a key, JAX's ``lax.switch`` traces one branch per bucket size;
    recorded, they are the port's ``kernel_sizes``, and every size the
    port draws from its generator comes from its level's bucket."""
    d = _data(7)
    cfg = {"weight": 1.0, "patch_size": (0.2, 0.9), "num_levels": 3, "kernel_buckets": 4}
    traced: list[int] = []

    class Recording(jl.LocalSSI):
        def _level(self, input, target, mask, key, k):
            traced.append(k)
            return super()._level(input, target, mask, key, k)

    jloss = Recording.build(cfg)
    jax.jit(jloss).lower(jnp.asarray(d["pred"]), jnp.asarray(d["gt"]), jnp.asarray(d["mask"]), rng=jax.random.key(0))
    tloss = tl.LocalSSI.build(cfg)
    buckets = tloss.kernel_sizes(H, W)
    assert traced == [k for level in buckets for k in level]
    assert any(len(level) > 1 for level in buckets)

    drawn: list[int] = []

    class Drawing(tl.LocalSSI):
        def _level(self, input, target, mask, k, shift=None):
            drawn.append(k)
            return super()._level(input, target, mask, k, shift)

    port = Drawing.build(cfg)
    args = (torch.from_numpy(d["pred"]), torch.from_numpy(d["gt"]), torch.from_numpy(d["mask"]))
    for seed in range(12):
        value = port(*args, rng=torch.Generator().manual_seed(seed))
        assert torch.isfinite(value).all()
    levels = [drawn[i::3] for i in range(3)]
    for level, bucket in zip(levels, buckets):
        assert set(level) <= set(bucket)
    assert any(len(set(level)) > 1 for level in levels)


def test_edge_guided_local_ssi_and_its_edge_coords():
    d = _data(8)
    cfg = {"weight": 1.0, "min_samples": 6, "use_global": True}
    jloss, tloss = _pair("EdgeGuidedLocalSSI", cfg)
    j_coords, j_ksize = jloss.edge_coords(jnp.asarray(d["image"]), jnp.asarray(d["validity"]), (H, W))
    t_coords, t_ksize = tloss.edge_coords(torch.from_numpy(d["image"]), torch.from_numpy(d["validity"]), (H, W))
    assert t_ksize == j_ksize
    np.testing.assert_array_equal(np.sort(t_coords.numpy(), axis=1), np.sort(np.asarray(j_coords), axis=1))
    _value_and_grad(
        lambda p: jloss(p, jnp.asarray(d["gt"]), jnp.asarray(d["mask"]), image=jnp.asarray(d["image"]),
                        validity_mask=jnp.asarray(d["validity"])),
        lambda p: tloss(p, torch.from_numpy(d["gt"]), torch.from_numpy(d["mask"]), image=torch.from_numpy(d["image"]),
                        validity_mask=torch.from_numpy(d["validity"])),
        [d["pred"]], d["weights"])


def test_arel_dummy_and_teacher_distill():
    d = _data(9)
    jloss, tloss = _pair("ARel", {"weight": 1.0})
    _value_and_grad(lambda p: jloss(p, jnp.asarray(d["gt"]), jnp.asarray(d["mask"])),
                    lambda p: tloss(p, torch.from_numpy(d["gt"]), torch.from_numpy(d["mask"])), [d["pred"]], d["weights"])
    jloss, tloss = _pair("TeacherDistill", {"weight": 1.0})
    teacher = np.random.default_rng(9).standard_normal((B, 12, 16)).astype(np.float32)
    student = np.random.default_rng(10).standard_normal((B, 12, 16)).astype(np.float32)
    _value_and_grad(lambda s: jloss(s, jnp.asarray(teacher)), lambda s: tloss(s, torch.from_numpy(teacher)),
                    [student], d["weights"])
    out = tl.Dummy.build({"weight": 0.0})(torch.from_numpy(d["pred"]))
    assert out.shape == (B,) and out.dtype == torch.float32 and not out.any()


def test_extract_patches_values_and_gradients():
    """Windows at the corners and the middle, reaching past the edge (zeros),
    and one start past the padded edge (clamped, as dynamic_slice does)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 20, 24, 3)).astype(np.float32)
    centers = np.array([[[0, 0], [19, 23], [10, 12], [5, 22]], [[3, 1], [18, 2], [25, 30], [7, 7]]], np.int32)
    weights = rng.standard_normal((2, 4, 5, 7, 3)).astype(np.float32)
    ref = j_extract_patches(jnp.asarray(x), jnp.asarray(centers), (5, 7))
    j_grad = jax.grad(lambda a: jnp.sum(j_extract_patches(a, jnp.asarray(centers), (5, 7)) * weights))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = extract_patches(xt, torch.from_numpy(centers), (5, 7))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    (t_grad,) = torch.autograd.grad((out * torch.from_numpy(weights)).sum(), xt)
    np.testing.assert_allclose(t_grad.numpy(), np.asarray(j_grad), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("zero_pad", [True, False])
def test_bilinear_sample_values_and_gradients(zero_pad):
    rng = np.random.default_rng(12)
    img = rng.standard_normal((2, 9, 11, 2)).astype(np.float32)
    coords = np.stack([rng.uniform(-1.5, 12.5, (2, 6, 7)), rng.uniform(-1.5, 10.5, (2, 6, 7))], -1).astype(np.float32)
    weights = rng.standard_normal((2, 6, 7, 2)).astype(np.float32)
    ref = j_bilinear_sample(jnp.asarray(img), jnp.asarray(coords), zero_pad)
    j_grads = jax.grad(lambda i, c: jnp.sum(j_bilinear_sample(i, c, zero_pad) * weights), argnums=(0, 1))(
        jnp.asarray(img), jnp.asarray(coords))
    it, ct = torch.from_numpy(img).requires_grad_(), torch.from_numpy(coords).requires_grad_()
    out = bilinear_sample(it, ct, zero_pad)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=1e-6)
    for tg, jg in zip(torch.autograd.grad((out * torch.from_numpy(weights)).sum(), (it, ct)), j_grads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL, atol=1e-5)
