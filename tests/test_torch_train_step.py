"""The port's V2 train step against the JAX package on shared weights, fp32
on the CPU: a small UniDepthV2 (DINOv2 C = 64, 4 blocks; decoder hidden 64)
built from the shipped ViT-L/14 config's training section, one seeded
``collate``d Dummy batch of 2 x 2 images at 28 x 56 (no token centre on the
principal point, where the ray azimuth is the sign of a rounding error).

Gates: loss slots at rtol 1e-5; every parameter's gradient at relative L2
error <= 1e-4, and exactly zero where JAX's is (the camera head: the given
rays replace its prediction). The exception is the part of each output head
between its LayerNorm and its LeakyReLU (``KINKED``), held at 1e-3: its
gradient flows through that LeakyReLU alone, whose slope jumps from 1 to
0.01 at 0, and the two packages' fp32 forwards differ by ~1e-6, so a
pre-activation that close to 0 (each micro-batch here has one within
2e-6; another seeded batch moved these gradients 3.05e-4) may take a
different slope in each. After one accum-2 step the parameters and
the EMA shadow are held at relative L2 <= 1e-5 a tensor, the Adam moments
at the gradients' gates (the second moment, a square, at twice them).
Then V1's loss slots on fabricated outputs, checkpoint resume (bit for
bit), and stochastic depth."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (sets this process's torch thread count)

from unidepth_tpu.io.convert import convert_v2_state_dict
from unidepth_tpu.models.unidepthv2.model import UniDepthV2 as JUniDepthV2
from unidepth_tpu.training.losses import build_losses as j_build_losses
from unidepth_tpu.training.optim import build_optimizer as j_build_optimizer
from unidepth_tpu.training.step import compute_losses_v1 as j_compute_losses_v1
from unidepth_tpu.training.step import compute_losses_v2 as j_compute_losses_v2
from unidepth_tpu.training.step import make_train_step as j_make_train_step
from unidepth_tpu.utils.misc import normalize_rgb as j_normalize_rgb
from unidepth_tpu_torch.datasets.dummy import Dummy
from unidepth_tpu_torch.datasets.loader import make_batch
from unidepth_tpu_torch.io.checkpoint import load_train_state, save_train_state
from unidepth_tpu_torch.io.convert import from_jax_params, from_jax_train_state
from unidepth_tpu_torch.models.backbones.dinov2 import DinoViT, ViTBlock, ViTConfig
from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2
from unidepth_tpu_torch.training.losses import build_losses
from unidepth_tpu_torch.training.optim import build_optimizer
from unidepth_tpu_torch.training.step import compute_losses_v1, compute_losses_v2, make_train_step, master_params
from unidepth_tpu_torch.training.trainer import build_trainer
from unidepth_tpu_torch.utils.misc import normalize_rgb

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (28, 56)


def tiny_config() -> dict:
    cfg = json.loads((ROOT / "configs/config_v2_vitl14.json").read_text())
    cfg["model"]["num_heads"] = 2
    cfg["model"]["pixel_decoder"].update(hidden_dim=64, out_dim=16, depths=[1, 1, 1])
    cfg["model"]["pixel_encoder"].update(name="dinov2_vits14", embed_dim=64, depth=4, num_heads=2, pos_embed_size=4,
                                         output_idx=[1, 2, 3, 4])
    cfg["training"].update(batch_size=2, nsteps_accumulation_gradient=2, warmup_iters=3, n_iters=20)
    cfg["data"]["image_shape"] = list(SHAPE)
    return cfg


CFG = tiny_config()


KINKED = tuple(f"pixel_decoder.depth_layer.{m}." for m in (
    "depth_mlp", "to_depth_lr", "to_depth_hr.0", "confidence_mlp", "to_confidence_lr", "to_confidence_hr.0"))


def _grad_gate(name: str) -> float:
    return 1e-3 if name.startswith(KINKED) else 1e-4


def _names(model):
    return [n for n, _ in model.named_parameters()]


@pytest.fixture(scope="module")
def shared():
    """(JAX model and params, port model, batch): the port's init_params plus
    noise, carried to JAX by the reference-schema converter."""
    tm = UniDepthV2.from_config(CFG, device="cpu").init_params(seed=0)
    rng = np.random.default_rng(0)
    sd = {k: (v.numpy() + 0.02 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in tm.state_dict().items()}
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    jm = JUniDepthV2.from_config(CFG, dtype=jnp.float32)
    jm.params = convert_v2_state_dict(sd, output_idx=(1, 2, 3, 4), num_levels=3, use_norm=True)
    batch = make_batch(Dummy(image_shape=SHAPE, length=64), 2, 2, np.random.default_rng(1))
    j_losses = j_build_losses(CFG)

    def j_loss(params, b):
        out = jm.encode_decode(params, j_normalize_rgb(b["image"]), rays_gt=b["rays"])
        d = j_compute_losses_v2(j_losses, out, b, None)
        return d["total"], d

    return jm, tm, batch, jax.jit(jax.value_and_grad(j_loss, has_aux=True))


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    den = want.double().norm().item()
    diff = (got.double() - want.double()).norm().item()
    return diff / den if den > 0 else diff


@pytest.mark.parametrize("micro", [0, 1])
def test_loss_slots_and_every_gradient_match_jax(shared, micro):
    jm, tm, batch, j_value_and_grad = shared
    mb = {k: v[micro] for k, v in batch.items()}
    (_, j_slots), j_grads = j_value_and_grad(jm.params, {k: jnp.asarray(v) for k, v in mb.items()})
    tb = {k: torch.as_tensor(v) for k, v in mb.items()}
    tm.zero_grad(set_to_none=True)
    out = tm.encode_decode(normalize_rgb(tb["image"]), rays_gt=tb["rays"])
    slots = compute_losses_v2(build_losses(CFG), out, tb, None)
    slots["total"].backward()
    assert set(slots) == set(j_slots) == {"depth", "camera", "invariance", "ssi", "confidence", "total"}
    for k in slots:
        np.testing.assert_allclose(slots[k].item(), float(j_slots[k]), rtol=1e-5, err_msg=k)
    want = from_jax_params(j_grads, CFG)
    zero = set()
    for name, p in tm.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        if not want[name].any():
            zero.add(name)
            assert not got.any(), name
        else:
            assert _rel_l2(got, want[name]) <= _grad_gate(name), name
    # the camera head's parameters alone get no gradient: rays_gt replaces its rays
    assert zero and all(n.startswith(("pixel_decoder.camera_layer.", "pixel_decoder.camera_token_adapter."))
                        for n in zero)
    tm.zero_grad(set_to_none=True)


def test_accum2_train_step_matches_jax(shared):
    jm, tm, batch, _ = shared
    tr = CFG["training"]
    kw = dict(lr=tr["lr"], lr_final=tr["lr_final"], encoder_lr=2e-6, wd=tr["wd"], wd_final=tr["wd_final"],
              warmup_iters=tr["warmup_iters"], total_iters=tr["n_iters"], ld=tr["ld"], num_encoder_layers=4,
              clipping=tr["clipping"], cycle_betas=tr["cycle_beta"])
    j_opt = j_build_optimizer(jm.params, **kw)
    j_init, j_step = j_make_train_step(jm, j_opt, CFG)
    j_state = j_init(jm.params)
    j_new, j_metrics = jax.jit(j_step)(j_state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0))

    names = _names(tm)
    state0 = from_jax_train_state(j_state, CFG, names)
    t_opt = build_optimizer(state0.params, **kw)
    t_init, t_step = make_train_step(tm, t_opt, CFG)
    before = {n: p.clone() for n, p in state0.params.items()}
    state, metrics = t_step(t_init(state0.params), batch, 0)  # updates the state in place
    for k in j_metrics:
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]), rtol=1e-5, err_msg=k)
    ref = from_jax_train_state(j_new, CFG, names)
    assert (state.step, state.opt_state.count, state.ema.num_updates) == (ref.step, ref.opt_state.count,
                                                                          ref.ema.num_updates) == (1, 1, 1)
    for n in names:
        assert _rel_l2(state.params[n], ref.params[n]) <= 1e-5, n
        assert _rel_l2(state.ema.shadow[n], ref.ema.shadow[n]) <= 1e-5, n
        assert _rel_l2(state.opt_state.mu[n], ref.opt_state.mu[n]) <= _grad_gate(n), n
        assert _rel_l2(state.opt_state.nu[n], ref.opt_state.nu[n]) <= 2 * _grad_gate(n), n
    assert all(not torch.equal(state.params[n], before[n]) for n in names if ref.opt_state.mu[n].any())


def test_compute_losses_v1_matches_jax():
    cfg = json.loads((ROOT / "configs/train_v1_vitl14.json").read_text())
    rng = np.random.default_rng(3)
    b, h, w = 4, 28, 28
    depth_gt = rng.uniform(1, 10, (b, h, w, 1)).astype(np.float32)
    rays_gt = rng.standard_normal((b, h * w, 3)).astype(np.float32)
    rays_gt /= np.linalg.norm(rays_gt, axis=-1, keepdims=True)
    outputs = {
        "depth": depth_gt * rng.uniform(0.9, 1.1, depth_gt.shape).astype(np.float32),
        "rays": rng.standard_normal((b, h, w, 3)).astype(np.float32),
        "depth_features": rng.standard_normal((b, 2, 2, 8)).astype(np.float32),
    }
    batch = {
        "depth": depth_gt, "depth_mask": np.ones((b, h, w, 1), bool), "rays": rays_gt,
        "K": np.broadcast_to(np.asarray([[[60.0, 0, 14], [0, 60.0, 14], [0, 0, 1]]], np.float32), (b, 3, 3)).copy(),
        "si": np.zeros(b, np.float32), "flips": np.array([False, True, False, False]),
    }
    j_out = j_compute_losses_v1(j_build_losses(cfg), jax.tree.map(jnp.asarray, outputs), jax.tree.map(jnp.asarray, batch),
                                jax.random.key(0))
    t_out = compute_losses_v1(build_losses(cfg), {k: torch.from_numpy(v) for k, v in outputs.items()},
                              {k: torch.from_numpy(v) for k, v in batch.items()}, None)
    assert set(t_out) == set(j_out) == {"depth", "camera", "invariance", "total"}
    for k in t_out:
        np.testing.assert_allclose(float(t_out[k]), float(j_out[k]), rtol=1e-5, err_msg=k)


def _steps(trainer, steps, seed=5):
    dataset = Dummy(image_shape=SHAPE, length=64)
    for step in steps:
        batch = make_batch(dataset, 2, 2, np.random.default_rng([seed, step]))
        trainer.step(batch, (seed, step))


def test_checkpoint_resume_is_bit_exact(tmp_path):
    """2 steps, save, a fresh trainer resumes and takes 1: equal to 3 straight
    steps, bit for bit (parameters, moments, shadow, counts)."""
    straight = build_trainer(CFG, device="cpu", seed=2)
    _steps(straight, range(3))
    first = build_trainer(CFG, device="cpu", seed=2)
    _steps(first, range(2))
    path = save_train_state(tmp_path, first.state)
    resumed = build_trainer(CFG, device="cpu", seed=2)
    resumed.state = load_train_state(path, resumed.state)
    assert resumed.state.step == 2
    _steps(resumed, range(2, 3))
    a, b = straight.state, resumed.state
    assert (a.step, a.opt_state.count, a.ema.num_updates) == (b.step, b.opt_state.count, b.ema.num_updates) == (3, 3, 3)
    for tree_a, tree_b in ((a.params, b.params), (a.opt_state.mu, b.opt_state.mu), (a.opt_state.nu, b.opt_state.nu),
                           (a.ema.shadow, b.ema.shadow)):
        for n in tree_a:
            assert torch.equal(tree_a[n], tree_b[n]), n
    resumed.sync_model()
    assert all(torch.equal(p, b.params[n]) for n, p in resumed.model.named_parameters())


def test_trainer_keeps_fp32_masters_beside_the_model():
    """The masters are float32 copies, never the model's own tensors."""
    trainer = build_trainer(CFG, device="cpu", seed=1)
    assert list(trainer.state.params) == _names(trainer.model)
    for n, p in trainer.model.named_parameters():
        master = trainer.state.params[n]
        assert master.dtype == torch.float32 and master.data_ptr() != p.data_ptr()
        assert torch.equal(master, p.detach())
    assert master_params(trainer.model).keys() == trainer.state.params.keys()


ENC = ViTConfig(embed_dim=32, depth=6, num_heads=2, pos_embed_size=4, output_idx=(2, 4, 5, 6))


def test_drop_path_rate_zero_equals_no_drop_path():
    torch.manual_seed(0)
    enc = DinoViT(ENC)
    image = torch.randn(3, 28, 42, 3)
    with torch.no_grad():
        ref = enc(image)
        out = enc(image, generator=torch.Generator().manual_seed(1))
    for a, b in zip(ref[0] + ref[1], out[0] + out[1]):
        assert torch.equal(a, b)


def test_drop_path_keeps_each_sample_at_one_minus_its_rate(monkeypatch):
    """At rate 0.5 the ramp linspace(0, 0.5, 6) gives each block its rate;
    over 100 forwards of 16 samples the keep share of every block's two
    masks sits within 5 binomial sigmas of 1 - rate, and a kept branch is
    scaled by 1 / keep."""
    import dataclasses

    cfg = dataclasses.replace(ENC, drop_path_rate=0.5)
    torch.manual_seed(0)
    enc = DinoViT(cfg)
    seen: dict[int, list] = {}
    real_forward = ViTBlock.forward

    def recording(self, x, keep_masks=None, keep=1.0):
        seen.setdefault(id(self), []).append((keep, keep_masks))
        return real_forward(self, x, keep_masks, keep)

    monkeypatch.setattr(ViTBlock, "forward", recording)
    gen = torch.Generator().manual_seed(0)
    image = torch.randn(16, 28, 28, 3)
    with torch.no_grad():
        for _ in range(100):
            enc(image, generator=gen)
    rates = np.linspace(0.0, 0.5, cfg.depth)
    for block, rate in zip(enc.blocks, rates):
        calls = seen[id(block)]
        if rate == 0.0:
            assert all(masks is None for _, masks in calls)
            continue
        keeps = torch.stack([masks for _, masks in calls]).float()  # (100, 2, 16)
        assert {k for k, _ in calls} == {1.0 - rate}
        n = keeps.numel()
        assert abs(keeps.mean().item() - (1.0 - rate)) <= 5 * np.sqrt(rate * (1 - rate) / n), rate
    from unidepth_tpu_torch.nn.layers import drop_path

    x = torch.randn(4, 3, 2)
    out = drop_path(x, torch.tensor([True, False, True, False]), 0.8)
    torch.testing.assert_close(out[0::2], x[0::2] / 0.8)
    assert not out[1::2].any()
