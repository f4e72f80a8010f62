"""The port's loader against the JAX package's on the CPU: ``ShapeSampler``
shapes, ``get_weights`` and ``WeightedConcat`` draws equal; the ``Loader``'s
stream with ``num_threads=0`` equal to JAX's for 4 batches over small
shards of real SPECS rows (arrays exact, rays within 1e-6); the ordered
mode under worker threads (more than cores, a short switch interval) giving
every ticket once in order with ``shape_for_batch``'s shape; a dying worker
raising in the consumer and ``close()`` joining; ``device_prefetch`` on the
CPU keeping order and values. Then the whole slice: one micro-batch from the
port's ``Loader`` through a small UniDepthV2's train forward and backward in
both packages, at tests/test_torch_train_step.py's gates."""

import json
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidepth_tpu.datasets import base as j_base
from unidepth_tpu.datasets import loader as j_loader
from unidepth_tpu.io.convert import convert_v2_state_dict
from unidepth_tpu.models.unidepthv2.model import UniDepthV2 as JUniDepthV2
from unidepth_tpu.training.losses import build_losses as j_build_losses
from unidepth_tpu.training.step import compute_losses_v2 as j_compute_losses_v2
from unidepth_tpu.utils.misc import normalize_rgb as j_normalize_rgb
from unidepth_tpu_torch.datasets import base, loader, synthetic
from unidepth_tpu_torch.io.convert import from_jax_params
from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2
from unidepth_tpu_torch.training.losses import build_losses
from unidepth_tpu_torch.training.step import compute_losses_v2
from unidepth_tpu_torch.utils.misc import normalize_rgb

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"KITTI": (356, 1222), "NYUv2Depth": (48, 64), "ARKit": (48, 64)}
CONSTRAINTS = {"ratio_bounds": (0.5, 2.5), "pixels_min": 1200, "pixels_max": 4000, "shape_mult": 14}


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    synthetic.write_hdf5(root, synthetic.make_shards(list(SMALL), 6, 1, shapes=SMALL))
    return str(root)


def _readers(pkg, root, **kw):
    return [pkg.make_dataset(n, data_root=root, image_shape=(28, 42), **kw) for n in SMALL]


def test_shape_sampler_weights_and_mixing_match_jax(shards):
    for seed in range(3):
        for c in (CONSTRAINTS, {"ratio_bounds": (0.5, 2.5), "pixels_min": 200000, "pixels_max": 600000,
                                "shape_mult": 14, "height_min": 500}):
            assert loader.ShapeSampler(c, seed=seed).shapes == j_loader.ShapeSampler(c, seed=seed).shapes
    port, jax_ = _readers(base, shards), _readers(j_base, shards)
    sampling = {"KITTI": 2.0, "ARKit": 0.5}
    np.testing.assert_array_equal(loader.get_weights(port, sampling), j_loader.get_weights(jax_, sampling))
    np.testing.assert_array_equal(loader.get_weights(port), j_loader.get_weights(jax_))
    pc, jc = loader.WeightedConcat(port, sampling=sampling), j_loader.WeightedConcat(jax_, sampling=sampling)
    rp, rj = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(50):
        (pd, pi), (jd, ji) = pc.sample(rp), jc.sample(rj)
        assert (pd.spec.name, pi) == (jd.spec.name, ji)


@pytest.mark.parametrize("accum, copies, ordered", [(2, 2, True), (1, 1, False)])
def test_single_thread_stream_matches_jax(shards, accum, copies, ordered):
    kw = dict(batch_size=4, accum=accum, num_threads=0, seed=3, num_copies=copies, shape_seed=3 if ordered else None)
    port = loader.Loader(loader.WeightedConcat(_readers(base, shards)),
                         shape_sampler=loader.ShapeSampler(CONSTRAINTS, seed=1), **kw)
    jax_ = j_loader.Loader(j_loader.WeightedConcat(_readers(j_base, shards)),
                           shape_sampler=j_loader.ShapeSampler(CONSTRAINTS, seed=1), **kw)
    shapes = set()
    for n, (got, want) in enumerate(zip(port, jax_)):
        if n == 4:
            break
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
            if k == "rays":
                np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0)
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        shapes.add(got["image"].shape[-3:-1])
        if ordered:
            assert got["image"].shape[-3:-1] == port.shape_for_batch(n)
    assert len(shapes) > 1


class _Shapes:
    """A dataset that returns a small sample of the requested shape."""

    def __init__(self, fail_at=None):
        self.fail_at = fail_at
        self.calls = 0

    def __len__(self):
        return 8

    def get_single_item(self, idx, rng, image_shape=None, base=None):
        self.calls += 1
        if self.fail_at is not None and self.calls >= self.fail_at:
            raise ValueError("broken sample")
        h, w = image_shape
        return {"image": np.full((h, w, 3), idx, np.uint8), "depth": np.ones((h, w), np.float32),
                "K": np.asarray([[10.0, 0, w / 2 + 0.3], [0, 10.0, h / 2 + 0.3], [0, 0, 1]], np.float32)}


def test_ordered_mode_under_threads_keeps_every_ticket_in_order():
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ld = loader.Loader(loader.WeightedConcat([_Shapes()]), batch_size=2, num_threads=16, prefetch=2,
                           shape_sampler=loader.ShapeSampler(CONSTRAINTS, seed=2), shape_seed=5)
        it = iter(ld)
        got = [next(it)["image"].shape[1:3] for _ in range(40)]
        assert got == [ld.shape_for_batch(n) for n in range(40)]
        assert len(ld._stash) <= ld.num_threads + ld.prefetch
        ld.close()
        assert not any(t.is_alive() for t in ld._threads)
    finally:
        sys.setswitchinterval(interval)
    with pytest.raises(RuntimeError, match="closed"):
        next(iter(ld))


def test_close_stops_a_worker_in_the_middle_of_a_slow_batch():
    """A batch of slow samples (here 16 of 0.5 s, 8 s a batch) takes longer
    than close() waits: the workers stop between samples."""
    slow = _Shapes()
    real = slow.get_single_item

    def get_single_item(*a, **k):
        time.sleep(0.5)
        return real(*a, **k)

    slow.get_single_item = get_single_item
    ld = loader.Loader(loader.WeightedConcat([slow]), batch_size=8, accum=2, num_threads=2,
                       shape_sampler=loader.ShapeSampler(CONSTRAINTS, seed=2), shape_seed=5)
    ld._threads = [threading.Thread(target=ld._worker, args=(t,), daemon=True) for t in range(2)]
    for t in ld._threads:
        t.start()
    time.sleep(1.0)
    t0 = time.perf_counter()
    ld.close()
    assert not ld._threads and time.perf_counter() - t0 < 3.0
    assert slow.calls < 2 * 16


def test_a_dying_worker_raises_in_the_consumer():
    ld = loader.Loader(loader.WeightedConcat([_Shapes(fail_at=1)]), batch_size=2, num_threads=2,
                       shape_sampler=loader.ShapeSampler(CONSTRAINTS, seed=2))
    ld._fetch_copies = lambda *a: (_ for _ in ()).throw(ValueError("collate failed"))  # past the retry
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="worker thread died") as err:
        next(iter(ld))
    assert isinstance(err.value.__cause__, ValueError) and time.perf_counter() - t0 < 30
    ld.close()
    assert not any(t.is_alive() for t in ld._threads)
    # a bad sample is retried with another index, not fatal
    flaky = _Shapes(fail_at=None)
    calls = iter([True, False] * 10)
    real = flaky.get_single_item
    flaky.get_single_item = lambda *a, **k: (_ for _ in ()).throw(IndexError("few points")) if next(calls) \
        else real(*a, **k)
    ld = loader.Loader(loader.WeightedConcat([flaky]), batch_size=2, num_threads=0,
                       shape_sampler=loader.ShapeSampler(CONSTRAINTS, seed=2))
    assert next(iter(ld))["image"].shape[0] == 2


def test_loader_refuses_multi_frame_readers_and_warns_on_identical_copies(shards):
    seq = base.make_dataset("ARKit", data_root=shards, image_shape=(28, 42))
    seq.num_frames = 3
    with pytest.raises(ValueError, match="single-frame"):
        loader.Loader(loader.WeightedConcat([seq]), batch_size=2)

    class Indexed:
        def __len__(self):
            return 4

        def __getitem__(self, idx):
            return {}

    with pytest.warns(UserWarning, match="identical"):
        loader.Loader(loader.WeightedConcat([Indexed()]), batch_size=2, num_copies=2, num_threads=0)


def test_device_prefetch_on_the_cpu_keeps_order_and_values():
    batches = [{"a": np.full((2, 3), i, np.float32), "m": np.arange(4) < i} for i in range(5)]
    out = list(loader.device_prefetch(iter(batches), "cpu", size=2))
    assert len(out) == 5
    for i, b in enumerate(out):
        assert all(torch.is_tensor(v) and v.device.type == "cpu" for v in b.values())
        np.testing.assert_array_equal(b["a"].numpy(), batches[i]["a"])
        np.testing.assert_array_equal(b["m"].numpy(), batches[i]["m"])


def _tiny_config() -> dict:
    cfg = json.loads((ROOT / "configs/config_v2_vitl14.json").read_text())
    cfg["model"]["num_heads"] = 2
    cfg["model"]["pixel_decoder"].update(hidden_dim=64, out_dim=16, depths=[1, 1, 1])
    cfg["model"]["pixel_encoder"].update(name="dinov2_vits14", embed_dim=64, depth=4, num_heads=2, pos_embed_size=4,
                                         output_idx=[1, 2, 3, 4])
    return cfg


KINKED = tuple(f"pixel_decoder.depth_layer.{m}." for m in (
    "depth_mlp", "to_depth_lr", "to_depth_hr.0", "confidence_mlp", "to_confidence_lr", "to_confidence_hr.0"))


def test_a_loader_batch_trains_as_in_jax(shards):
    """One micro-batch of the port's Loader (threads, shape sampling) through
    the V2 train forward and backward in both packages on shared weights:
    loss slots at rtol 1e-5, gradients at relative L2 1e-4 (1e-3 where
    tests/test_torch_train_step.py holds them so: behind a LeakyReLU kink)."""
    cfg = _tiny_config()
    ld = loader.Loader(loader.WeightedConcat(_readers(base, shards)), batch_size=2, num_threads=2, seed=4,
                       shape_sampler=loader.ShapeSampler(CONSTRAINTS, seed=3), shape_seed=4)
    try:
        batch = next(iter(ld))
    finally:
        ld.close()
    tm = UniDepthV2.from_config(cfg, device="cpu").init_params(seed=0)
    rng = np.random.default_rng(0)
    sd = {k: (v.numpy() + 0.02 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in tm.state_dict().items()}
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    jm = JUniDepthV2.from_config(cfg, dtype=jnp.float32)
    jm.params = convert_v2_state_dict(sd, output_idx=(1, 2, 3, 4), num_levels=3, use_norm=True)
    j_losses = j_build_losses(cfg)

    def j_loss(params, b):
        out = jm.encode_decode(params, j_normalize_rgb(b["image"]), rays_gt=b["rays"])
        d = j_compute_losses_v2(j_losses, out, b, None)
        return d["total"], d

    (_, j_slots), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jm.params, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = next(loader.device_prefetch(iter([batch]), "cpu"))
    out = tm.encode_decode(normalize_rgb(tb["image"]), rays_gt=tb["rays"])
    slots = compute_losses_v2(build_losses(cfg), out, tb, None)
    slots["total"].backward()
    for k in slots:
        np.testing.assert_allclose(slots[k].item(), float(j_slots[k]), rtol=1e-5, err_msg=k)
    want = from_jax_params(j_grads, cfg)
    for name, p in tm.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        den = want[name].double().norm().item()
        err = (got.double() - want[name].double()).norm().item()
        assert (err / den if den else err) <= (1e-3 if name.startswith(KINKED) else 1e-4), name


def test_edge_patches_take_the_lower_index_among_equal_cells():
    """Blocky images (as real data has) leave many 1/14 cells with equal edge
    strength; EdgeGuidedLocalSSI picks its patches among them as lax.top_k
    does, the lower index first (a plain torch.topk picked others: the
    loader-fed step above then missed JAX's ssi slot by 1%)."""
    from unidepth_tpu.training.losses import EdgeGuidedLocalSSI as JEdge
    from unidepth_tpu_torch.training.losses import EdgeGuidedLocalSSI

    image = np.zeros((2, 56, 140, 3), np.float32)
    image[:, :, 70:] = 200.0  # one vertical edge; every other cell is flat
    image[1, 28:] += 50.0
    valid = np.ones((2, 56, 140, 1), bool)
    want, k_want = JEdge(weight=1.0).edge_coords(jnp.asarray(image), jnp.asarray(valid), (56, 140))
    got, k_got = EdgeGuidedLocalSSI(weight=1.0).edge_coords(torch.from_numpy(image), torch.from_numpy(valid),
                                                            (56, 140))
    assert k_got == k_want
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
