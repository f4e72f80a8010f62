"""Training of UniDepthV1 (ViT and ConvNeXt) and UniDepthV2old in the port
against the JAX package on shared weights, fp32 on the CPU.

Three tiny models with the shipped configs' training sections: V1 with a
DINOv2 encoder (C = 64, 4 blocks, 2 heads) at 28 x 56, V1 with a ConvNeXt
(depths (1, 1, 2, 1), dims 32-256) at 64 x 96, V2old (C = 64, 4 blocks, the
final norm) at 28 x 56; decoder hidden 32. JAX's init plus seeded noise is
carried to the port by ``from_jax_params``; one seeded ``collate``d Dummy
batch of 2 x 2 images. V1 takes V1's loss slots (depth, camera,
invariance), V2old V2's five, as the JAX trainer gives them.

Gates: every loss slot at rtol 1e-4; every parameter's gradient at
relative L2 <= 1e-3 against ``jax.grad`` of JAX's loss, and zero exactly
where JAX's is. After one accum-2 step (``build_trainer``'s step against
JAX's ``train_step``): parameters and EMA shadow at relative L2 <= 1e-5 a
tensor, the first Adam moment at the gradients' gate, the second (a
square) at twice it, as the V2 step is held (tests/test_torch_train_step.py).

Some gradients are zero in exact arithmetic and rounding noise in both
packages: the key half of every decoder attention's ``kv`` bias (a softmax
does not see a shift common to its logits), and in V2old the biases whose
shift its whole-map log-depth norm removes. Their norm sits 1e-8 of the
global gradient's or below, against 1e-5 for the smallest real one here.
So a gradient tensor under NOISE_TENSOR of the global norm is held at
``||got - want|| <= NOISE_TENSOR * ||global||``; after the step, the
elements whose mean gradient (JAX's first moment / (1 - b1)) is under
NOISE_ELEMENT of the global norm are held at bounds instead of at the
relative gates: the first moment under that noise times (1 - b1), the
second under its square times (1 - b2), and the parameter within two
learning rates of JAX's (Adam turns noise into a full step of either sign).

Then the repairs: V1's depth head takes the rays without their gradient
(a depth-only loss with no GT rays leaves the camera head at zero, as in
JAX); ConvNeXt's stochastic depth (rate 0 is none; each sample kept at 1 -
its rate; a kept branch scaled by 1 / keep) and its checkpointed blocks;
the layer decay of a ConvNeXt's blocks across its stages against JAX's
scanned stages; bit-exact checkpoint resume of each family's trainer;
and ``MetricLogger`` and ``log_train_artifacts`` against JAX's.
"""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (sets this process's torch thread count)

from unidepth_tpu.models.backbones.convnext import ConvNeXt as JConvNeXt
from unidepth_tpu.models.backbones.convnext import ConvNeXtConfig as JConvNeXtConfig
from unidepth_tpu.models.backbones.dinov2 import ViTConfig as JViTConfig
from unidepth_tpu.models.unidepthv1.model import UniDepthV1 as JUniDepthV1
from unidepth_tpu.models.unidepthv2.old import UniDepthV2old as JUniDepthV2old
from unidepth_tpu.training.losses import build_losses as j_build_losses
from unidepth_tpu.training.optim import build_optimizer as j_build_optimizer
from unidepth_tpu.training.optim import lr_scale_tree as j_lr_scale_tree
from unidepth_tpu.training.step import compute_losses_v1 as j_compute_losses_v1
from unidepth_tpu.training.step import compute_losses_v2 as j_compute_losses_v2
from unidepth_tpu.training.step import make_train_step as j_make_train_step
from unidepth_tpu.training.step import make_train_step_v1 as j_make_train_step_v1
from unidepth_tpu.utils.logging import MetricLogger as JMetricLogger
from unidepth_tpu.utils.misc import normalize_rgb as j_normalize_rgb
from unidepth_tpu.utils.visualization import log_train_artifacts as j_log_train_artifacts
from unidepth_tpu_torch.datasets.dummy import Dummy
from unidepth_tpu_torch.datasets.loader import make_batch
from unidepth_tpu_torch.io.checkpoint import load_train_state, save_train_state
from unidepth_tpu_torch.io.convert import from_jax_params, from_jax_train_state
from unidepth_tpu_torch.models.backbones.convnext import ConvNeXt, ConvNeXtBlock, ConvNeXtConfig
from unidepth_tpu_torch.models.unidepthv1.model import UniDepthV1
from unidepth_tpu_torch.models.unidepthv2.old import UniDepthV2old
from unidepth_tpu_torch.nn.layers import drop_path
from unidepth_tpu_torch.training.losses import build_losses
from unidepth_tpu_torch.training.optim import lr_scale_tree
from unidepth_tpu_torch.training.step import compute_losses_v1, compute_losses_v2
from unidepth_tpu_torch.training.trainer import build_trainer, num_encoder_layers
from unidepth_tpu_torch.utils.logging import MetricLogger
from unidepth_tpu_torch.utils.misc import normalize_rgb
from unidepth_tpu_torch.utils.png import read_png
from unidepth_tpu_torch.utils.visualization import log_train_artifacts

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL, GRAD_GATE, STEP_GATE = 1e-4, 1e-3, 1e-5
NOISE_TENSOR, NOISE_ELEMENT = 1e-6, 1e-7  # of the global gradient norm: see above
VIT = dict(embed_dim=64, depth=4, num_heads=2, pos_embed_size=4, output_idx=(1, 2, 3, 4))
CNX_DEPTHS, CNX_DIMS = (1, 1, 2, 1), (32, 64, 128, 256)


def _config(shipped: str, encoder: dict, shape, decoder_depths=(1, 1, 1)) -> dict:
    cfg = json.loads((ROOT / "configs" / shipped).read_text())
    cfg["model"]["num_heads"] = 2
    cfg["model"]["pixel_decoder"].update(hidden_dim=32, depths=list(decoder_depths))
    cfg["model"]["pixel_encoder"] = {**cfg["model"]["pixel_encoder"], **encoder}
    cfg["training"].update(batch_size=2, nsteps_accumulation_gradient=2, warmup_iters=3, n_iters=20)
    cfg["data"]["image_shape"] = list(shape)
    return cfg


V1_VIT_ENCODER = {"name": "dinov2_vits14", **VIT, "output_idx": list(VIT["output_idx"])}
FAMILIES = {
    "v1-vit": _config("config_v1_vitl14.json", V1_VIT_ENCODER, (28, 56)),
    "v1-convnext": _config("config_v1_cnvnxtl.json", {"depths": list(CNX_DEPTHS), "dims": list(CNX_DIMS)}, (64, 96)),
    "v2old": _config("config_v2old_vitl14.json", {**V1_VIT_ENCODER, "use_norm": True}, (28, 56)),
}


def _noisy(params, seed):
    """JAX init plus seeded noise: zero biases, tokens, GRN and 1e-6 layer
    scales would otherwise hide whole branches."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
                                  params)


def _jax_model(family: str, cfg: dict):
    shape = tuple(cfg["data"]["image_shape"])
    if family == "v2old":
        return JUniDepthV2old(JViTConfig(**VIT, use_norm=True), hidden_dim=32, decoder_depths=(1, 1, 1), num_heads=2,
                              dtype=jnp.float32)
    if family == "v1-vit":
        return JUniDepthV1(JViTConfig(**VIT, use_norm=False, interpolate_offset=0.1), hidden_dim=32,
                           decoder_depths=(1, 1, 1), num_heads=2, image_shape=shape, dtype=jnp.float32)
    enc = JConvNeXt(cfg=JConvNeXtConfig(depths=CNX_DEPTHS, dims=CNX_DIMS), stacking="max_cls", dtype=jnp.float32)
    return JUniDepthV1(None, hidden_dim=32, decoder_depths=(1, 1, 1), num_heads=2, image_shape=shape,
                       dtype=jnp.float32, encoder_module=enc)


def _jit_init(family: str, jm, shape, seed=0):
    """The model's ``init_params`` with both inits jitted (eager flax init
    is several times slower on the CPU)."""
    k1, k2 = jax.random.split(jax.random.key(seed))
    img = jnp.zeros((1, *shape, 3), jnp.float32)
    enc = jax.jit(jm.encoder.init)(k1, img)
    feats, cls_tokens = jax.eval_shape(jm.encoder.apply, enc, img)
    feats = [jnp.zeros(f.shape, jnp.float32) for f in feats]
    cls = [jnp.zeros(c.shape, jnp.float32) for c in cls_tokens]
    if family == "v2old":
        dec = jax.jit(jm.decoder.init, static_argnums=4)(k2, feats, [cls[-3], cls[-2], cls[-1], cls[-2]],
                                                         [cls[-2], cls[-1]], shape)
    else:
        dec = jax.jit(jm.decoder.init, static_argnums=3)(k2, feats, cls, shape)
    return {"encoder": enc["params"], "decoder": dec["params"]}


def _recipes(family):
    return (compute_losses_v2, j_compute_losses_v2) if family == "v2old" else (compute_losses_v1, j_compute_losses_v1)


def _port_model(family: str, cfg: dict, params):
    cls = UniDepthV2old if family == "v2old" else UniDepthV1
    tm = cls.from_config(cfg, device="cpu")
    tm.load_state_dict(from_jax_params(params, cfg))
    return tm


@pytest.fixture(scope="module", params=list(FAMILIES))
def shared(request):
    """(family, config, JAX model, port model, batch, JAX loss-and-grad)."""
    family = request.param
    cfg = FAMILIES[family]
    shape = tuple(cfg["data"]["image_shape"])
    jm = _jax_model(family, cfg)
    jm.params = _noisy(_jit_init(family, jm, shape), 1)
    tm = _port_model(family, cfg, jm.params)
    batch = make_batch(Dummy(image_shape=shape, length=64), 2, 2, np.random.default_rng(1))
    j_losses, j_recipe = j_build_losses(cfg), _recipes(family)[1]

    def j_loss(params, b):
        out = jm.encode_decode(params, j_normalize_rgb(b["image"]), rays_gt=b["rays"])
        d = j_recipe(j_losses, out, b, None)
        return d["total"], d

    return family, cfg, jm, tm, batch, jax.jit(jax.value_and_grad(j_loss, has_aux=True))


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    den = want.double().norm().item()
    diff = (got.double() - want.double()).norm().item()
    return diff / den if den > 0 else diff


def test_loss_slots_and_every_gradient_match_jax(shared):
    family, cfg, jm, tm, batch, j_value_and_grad = shared
    mb = {k: v[0] for k, v in batch.items()}
    (_, j_slots), j_grads = j_value_and_grad(jm.params, {k: jnp.asarray(v) for k, v in mb.items()})
    tb = {k: torch.as_tensor(v) for k, v in mb.items()}
    tm.zero_grad(set_to_none=True)
    out = tm.encode_decode(normalize_rgb(tb["image"]), rays_gt=tb["rays"])
    slots = _recipes(family)[0](build_losses(cfg), out, tb, None)
    slots["total"].backward()
    expected = {"depth", "camera", "invariance", "total"} | ({"ssi", "confidence"} if family == "v2old" else set())
    assert set(slots) == set(j_slots) == expected
    for k in slots:
        np.testing.assert_allclose(slots[k].item(), float(j_slots[k]), rtol=LOSS_RTOL, err_msg=k)
    want = from_jax_params(j_grads, cfg)
    total = torch.linalg.vector_norm(torch.stack([w.double().norm() for w in want.values()])).item()
    held = 0
    for name, p in tm.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        if not want[name].any():
            assert not got.any(), name
        elif want[name].double().norm().item() <= NOISE_TENSOR * total:
            assert (got.double() - want[name].double()).norm().item() <= NOISE_TENSOR * total, name
        else:
            held += 1
            assert _rel_l2(got, want[name]) <= GRAD_GATE, (name, _rel_l2(got, want[name]))
    assert held > len(want) // 2
    tm.zero_grad(set_to_none=True)


def test_accum2_train_step_matches_jax(shared):
    """``build_trainer``'s step (the family's recipe, AdamW, EMA) against
    JAX's ``make_train_step``/``make_train_step_v1`` on the same state."""
    family, cfg, jm, _, batch, _ = shared
    trainer = build_trainer(cfg, device="cpu")
    names = list(trainer.state.params)
    tr = cfg["training"]
    kw = dict(lr=tr["lr"], lr_final=tr["lr_final"], encoder_lr=2e-6, wd=tr["wd"], wd_final=tr["wd_final"],
              warmup_iters=tr["warmup_iters"], total_iters=tr["n_iters"], ld=tr["ld"],
              num_encoder_layers=num_encoder_layers(trainer.model), clipping=tr["clipping"],
              cycle_betas=tr["cycle_beta"])
    j_opt = j_build_optimizer(jm.params, **kw)
    j_init, j_step = (j_make_train_step if family == "v2old" else j_make_train_step_v1)(jm, j_opt, cfg)
    j_state = j_init(jm.params)
    j_new, j_metrics = jax.jit(j_step)(j_state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0))

    trainer.state = from_jax_train_state(j_state, cfg, names)
    before = {n: p.clone() for n, p in trainer.state.params.items()}
    metrics = trainer.step(batch, 0)
    for k in j_metrics:
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]), rtol=LOSS_RTOL, err_msg=k)
    state, ref = trainer.state, from_jax_train_state(j_new, cfg, names)
    assert (state.step, state.opt_state.count, state.ema.num_updates) == (ref.step, ref.opt_state.count,
                                                                          ref.ema.num_updates) == (1, 1, 1)
    hp = trainer.optimizer.hyperparams(0)
    b1, b2 = hp["b1"], trainer.optimizer.b2
    grads = {n: ref.opt_state.mu[n].double() / (1 - b1) for n in names}  # JAX's clipped mean gradient
    floor = NOISE_ELEMENT * torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()])).item()
    for n in names:
        assert _rel_l2(state.ema.shadow[n], ref.ema.shadow[n]) <= STEP_GATE, n
        noise = grads[n].abs() <= floor
        real = ~noise
        assert _rel_l2(state.params[n][real], ref.params[n][real]) <= STEP_GATE, n
        assert _rel_l2(state.opt_state.mu[n][real], ref.opt_state.mu[n][real]) <= GRAD_GATE, n
        assert _rel_l2(state.opt_state.nu[n][real], ref.opt_state.nu[n][real]) <= 2 * GRAD_GATE, n
        if noise.any():
            assert (state.params[n][noise] - ref.params[n][noise]).abs().max() <= 2.01 * hp["lr"], n
            assert state.opt_state.mu[n][noise].abs().max() <= (1 - b1) * floor, n
            assert state.opt_state.nu[n][noise].max() <= (1 - b2) * floor**2, n
    assert all(not torch.equal(state.params[n], before[n]) for n in names if ref.opt_state.mu[n].any())



# ---- F1: V1's depth head takes the rays without their gradient -------------------


@pytest.mark.parametrize("shared", ["v1-vit"], indirect=True)
def test_v1_depth_loss_without_gt_rays_leaves_the_camera_head_alone(shared):
    """A depth-only loss with no GT rays: the depth head is conditioned on
    the predicted camera's rays, whose gradient JAX stops
    (``stop_gradient(rays_hr)``). Every gradient matches JAX's, and the
    camera head's and the cls-token adapters' are zero in both."""
    family, cfg, jm, tm, batch, _ = shared
    mb = {k: v[1] for k, v in batch.items()}
    j_depth = j_build_losses(cfg)["depth"]

    def j_loss(params, b):
        out = jm.encode_decode(params, j_normalize_rgb(b["image"]))
        return j_depth.weight * j_depth(out["depth"], b["depth"], b["depth_mask"], si=b["si"]).mean()

    j_value, j_grads = jax.jit(jax.value_and_grad(j_loss))(jm.params, {k: jnp.asarray(v) for k, v in mb.items()})
    tb = {k: torch.as_tensor(v) for k, v in mb.items()}
    depth = build_losses(cfg)["depth"]
    tm.zero_grad(set_to_none=True)
    out = tm.encode_decode(normalize_rgb(tb["image"]))
    loss = depth.weight * depth(out["depth"], tb["depth"], tb["depth_mask"], si=tb["si"]).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_value), rtol=LOSS_RTOL)
    want = from_jax_params(j_grads, cfg)
    total = torch.linalg.vector_norm(torch.stack([w.double().norm() for w in want.values()])).item()
    zero = set()
    for name, p in tm.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        if not want[name].any():
            zero.add(name)
            assert not got.any(), f"{name}: a gradient where JAX has none"
        elif want[name].double().norm().item() <= NOISE_TENSOR * total:
            assert (got.double() - want[name].double()).norm().item() <= NOISE_TENSOR * total, name
        else:
            assert _rel_l2(got, want[name]) <= GRAD_GATE, (name, _rel_l2(got, want[name]))
    head = {n for n, _ in tm.named_parameters()
            if n.startswith(("pixel_decoder.camera_layer.", "pixel_decoder.token_adapter."))}
    assert head and zero == head
    tm.zero_grad(set_to_none=True)


# ---- F3: ConvNeXt's stochastic depth and checkpointed blocks --------------------

SMALL_CNX = ConvNeXtConfig(depths=CNX_DEPTHS, dims=CNX_DIMS)


def test_convnext_drop_path_rate_zero_equals_no_drop_path():
    torch.manual_seed(0)
    enc = ConvNeXt(SMALL_CNX)
    image = torch.randn(3, 64, 96, 3)
    with torch.no_grad():
        ref = enc(image)
        out = enc(image, generator=torch.Generator().manual_seed(1))
    for a, b in zip(ref[0] + ref[1], out[0] + out[1]):
        assert torch.equal(a, b)


def test_convnext_drop_path_keeps_each_sample_at_one_minus_its_rate(monkeypatch):
    """At rate 0.5 the ramp linspace(0, 0.5, 5) over all the blocks gives
    each its rate; over 40 forwards of 40 samples each block's keep share
    sits within 5 binomial sigmas of 1 - rate, and a dropped sample's branch
    is gone while a kept one is scaled by 1 / keep."""
    cfg = ConvNeXtConfig(depths=CNX_DEPTHS, dims=CNX_DIMS, drop_path_rate=0.5)
    torch.manual_seed(0)
    enc = ConvNeXt(cfg)
    seen: dict[int, list] = {}
    real_forward = ConvNeXtBlock.forward

    def recording(self, x, keep_mask=None, keep=1.0):
        seen.setdefault(id(self), []).append((keep, keep_mask))
        return real_forward(self, x, keep_mask, keep)

    monkeypatch.setattr(ConvNeXtBlock, "forward", recording)
    gen = torch.Generator().manual_seed(0)
    image = torch.randn(40, 32, 32, 3)
    with torch.no_grad():
        for _ in range(40):
            enc(image, generator=gen)
    blocks = [b for stage in enc.stages for b in stage.blocks]
    rates = np.linspace(0.0, 0.5, len(blocks))
    for block, rate in zip(blocks, rates):
        calls = seen[id(block)]
        if rate == 0.0:
            assert all(mask is None for _, mask in calls)
            continue
        assert {k for k, _ in calls} == {1.0 - rate}
        keeps = torch.stack([mask for _, mask in calls]).float()  # (40, 40)
        assert abs(keeps.mean().item() - (1.0 - rate)) <= 5 * np.sqrt(rate * (1 - rate) / keeps.numel()), rate
    block = blocks[-1]
    x = torch.randn(4, 4, 4, CNX_DIMS[-1])
    mask = torch.tensor([True, False, True, False])
    with torch.no_grad():
        branch = real_forward(block, x) - x
        out = real_forward(block, x, mask, 0.8)
    torch.testing.assert_close(out[0::2], x[0::2] + branch[0::2] / 0.8)
    torch.testing.assert_close(out[1::2], x[1::2])
    torch.testing.assert_close(drop_path(branch, mask, 0.8)[0::2], branch[0::2] / 0.8)


def test_convnext_blocks_are_checkpointed_with_their_draw(monkeypatch):
    """Under autograd each block runs twice (the forward, then its recompute
    in the backward) with the same keep mask, and the gradients equal those
    of the same forward without checkpointing."""
    from unidepth_tpu_torch.models.backbones import convnext as convnext_module

    cfg = ConvNeXtConfig(depths=CNX_DEPTHS, dims=CNX_DIMS, drop_path_rate=0.3)
    torch.manual_seed(0)
    enc = ConvNeXt(cfg)
    image = torch.randn(2, 32, 32, 3)
    calls: dict[int, list] = {}
    real_forward = ConvNeXtBlock.forward

    def recording(self, x, keep_mask=None, keep=1.0):
        calls.setdefault(id(self), []).append(keep_mask)
        return real_forward(self, x, keep_mask, keep)

    def run():
        feats, tokens = enc(image, generator=torch.Generator().manual_seed(3))
        sum(f.square().mean() for f in feats + tokens).backward()
        grads = {n: p.grad.clone() for n, p in enc.named_parameters()}
        enc.zero_grad(set_to_none=True)
        return grads

    monkeypatch.setattr(ConvNeXtBlock, "forward", recording)
    checkpointed = run()
    blocks = [b for stage in enc.stages for b in stage.blocks]
    for block in blocks:
        first, again = calls[id(block)]
        assert (first is None and again is None) or torch.equal(first, again)
    assert any(calls[id(b)][0] is not None and not calls[id(b)][0].all() for b in blocks)
    monkeypatch.setattr(convnext_module, "checkpoint", lambda fn, *args, **_: fn(*args))
    calls.clear()
    plain = run()
    assert all(len(c) == 1 for c in calls.values())
    for n in plain:
        torch.testing.assert_close(checkpointed[n], plain[n], rtol=0, atol=0)


def test_v1_encode_decode_generator_turns_on_drop_path():
    """``from_config`` reads ``drop_path`` (the encoder's key, else the
    training section's) into either encoder; ``encode_decode`` applies it
    only when given a generator."""
    for family in ("v1-vit", "v1-convnext"):
        cfg = copy.deepcopy(FAMILIES[family])
        cfg["training"]["drop_path"] = 0.4
        model = UniDepthV1.from_config(cfg, device="cpu").init_params(seed=0)
        assert model.pixel_encoder.cfg.drop_path_rate == 0.4
        image = torch.randn(2, *cfg["data"]["image_shape"], 3)
        with torch.no_grad():
            ref = model.encode_decode(image)["depth"]
            again = model.encode_decode(image)["depth"]
            dropped = model.encode_decode(image, generator=torch.Generator().manual_seed(0))["depth"]
        assert torch.equal(ref, again) and not torch.equal(ref, dropped)


# ---- F4: layer decay numbers a ConvNeXt's blocks across its stages ---------------


def test_lr_scale_tree_numbers_convnext_blocks_across_stages(shared_convnext_params):
    """At ld = 0.9, the port's per-parameter scales against JAX's, each
    scanned stage split into its blocks: block j of stage s is layer
    (blocks before s) + j + 1; the stem and the downsample layers layer 0;
    the decoder 1."""
    j_params, names, cfg = shared_convnext_params
    depth = sum(CNX_DEPTHS)
    scale, ld = 0.02, 0.9
    j_scales = j_lr_scale_tree(j_params, scale, ld, depth)
    got = lr_scale_tree(dict.fromkeys(names), scale, ld, depth)
    enc = j_scales["encoder"]
    for name, value in got.items():
        if not name.startswith("pixel_encoder."):
            assert value == 1.0, name
            continue
        parts = name.split(".")
        if parts[1] == "stages" and parts[3] == "blocks":
            s, j = int(parts[2]), int(parts[4])
            want = {np.asarray(leaf)[j].item() for leaf in jax.tree.leaves(enc[f"stage_{s}"])}
            assert len(want) == 1
            np.testing.assert_allclose(value, want.pop(), rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_allclose(value, float(enc["stem_conv"]["kernel"]), rtol=1e-6, err_msg=name)
    layer0 = {float(v) for k, sub in enc.items() if not k.startswith("stage_") for v in jax.tree.leaves(sub)}
    np.testing.assert_allclose(sorted(layer0), [scale * ld**depth] * len(layer0), rtol=1e-6)
    stage_ids = [v for n, v in got.items() if ".stages." in n and ".blocks." in n]
    assert len(set(stage_ids)) == depth


@pytest.fixture(scope="module")
def shared_convnext_params():
    cfg = FAMILIES["v1-convnext"]
    jm = _jax_model("v1-convnext", cfg)
    # the scales follow the tree's paths and shapes only: no init to compile
    params = jax.eval_shape(lambda: _jit_init("v1-convnext", jm, tuple(cfg["data"]["image_shape"])))
    names = [n for n, _ in UniDepthV1.from_config(cfg, device="cpu").named_parameters()]
    return params, names, cfg


# ---- checkpoint resume of the new trainers ---------------------------------------


def _steps(trainer, cfg, steps, seed=5):
    dataset = Dummy(image_shape=tuple(cfg["data"]["image_shape"]), length=64)
    for step in steps:
        trainer.step(make_batch(dataset, 2, 2, np.random.default_rng([seed, step])), (seed, step))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_checkpoint_resume_is_bit_exact(family, tmp_path):
    """2 steps, save, a fresh trainer resumes and takes 1: equal to 3 straight
    steps, bit for bit (parameters, moments, shadow, counts)."""
    cfg = FAMILIES[family]
    straight = build_trainer(cfg, device="cpu", seed=2)
    _steps(straight, cfg, range(3))
    first = build_trainer(cfg, device="cpu", seed=2)
    _steps(first, cfg, range(2))
    path = save_train_state(tmp_path, first.state)
    resumed = build_trainer(cfg, device="cpu", seed=2)
    resumed.state = load_train_state(path, resumed.state)
    assert resumed.state.step == 2
    _steps(resumed, cfg, range(2, 3))
    a, b = straight.state, resumed.state
    assert (a.step, a.opt_state.count, a.ema.num_updates) == (b.step, b.opt_state.count, b.ema.num_updates) == (3, 3, 3)
    for tree_a, tree_b in ((a.params, b.params), (a.opt_state.mu, b.opt_state.mu), (a.opt_state.nu, b.opt_state.nu),
                           (a.ema.shadow, b.ema.shadow)):
        assert list(tree_a) == list(tree_b)
        for n in tree_a:
            assert torch.equal(tree_a[n], tree_b[n]), n
    resumed.sync_model()
    assert all(torch.equal(p, b.params[n]) for n, p in resumed.model.named_parameters())


def test_build_trainer_builds_each_family_at_its_shape():
    """V1 is built at the floored training shape, written into its
    ``data.image_shape``; every family's masters are fp32 copies; V1 takes
    V1's recipe, V2old V2's; layer decay's depth is a ConvNeXt's block
    count."""
    cfg = copy.deepcopy(FAMILIES["v1-convnext"])
    cfg["data"]["image_shape"] = [70, 100]
    trainer = build_trainer(cfg, device="cpu", seed=1)
    assert trainer.model.image_shape == (70, 98) and cfg["data"]["image_shape"] == [70, 100]
    assert num_encoder_layers(trainer.model) == sum(CNX_DEPTHS)
    v2old = build_trainer(FAMILIES["v2old"], device="cpu", seed=1)
    assert isinstance(v2old.model, UniDepthV2old) and num_encoder_layers(v2old.model) == VIT["depth"]
    for t in (trainer, v2old):
        for n, p in t.model.named_parameters():
            assert t.state.params[n].dtype == torch.float32 and t.state.params[n].data_ptr() != p.data_ptr()
    with pytest.raises(ValueError, match="unknown model"):
        build_trainer({**cfg, "model": {**cfg["model"], "name": "UniDepthV3"}}, device="cpu")


# ---- MetricLogger and the training artifacts -------------------------------------


def test_metric_logger_matches_jax(tmp_path):
    """The JSONL records (but their wall-clock ``t``) and the EMA dicts of a
    sequence with a NaN and an overflow, against JAX's ``MetricLogger``;
    ``log_image`` writes a PNG that ``utils/png.py`` reads back bit for bit,
    and records its path."""
    seq = [({"depth": 1.0, "total": 2.5}, 1, "train"), ({"depth": 0.5, "total": float("nan")}, 2, "train"),
           ({"depth": torch.tensor(0.25), "total": 1e31}, 3, "train"), ({"Dummy/d1": 0.7}, 3, "val"),
           ({"depth": 0.125, "total": 1.0}, 4, "train")]
    port = MetricLogger(run_name="run", out_dir=tmp_path / "port")
    ref = JMetricLogger(run_name="run", out_dir=str(tmp_path / "jax"))
    for metrics, step, prefix in seq:
        got = port.log(metrics, step, prefix=prefix)
        want = ref.log({k: float(v) for k, v in metrics.items()}, step, prefix=prefix)
        assert got == want
    image = np.random.default_rng(0).integers(0, 256, (6, 10, 3), dtype=np.uint8)
    path = port.log_image("grid", image, 4)
    port.close()
    ref.close()

    def records(p):
        return [{k: v for k, v in json.loads(line).items() if k != "t"} for line in Path(p).read_text().splitlines()]

    got, want = records(tmp_path / "port" / "run.jsonl"), records(tmp_path / "jax" / "run.jsonl")
    assert json.dumps(got[:-1]) == json.dumps(want)  # as text: NaN is not equal to itself
    assert got[-1] == {"step": 4, "image/grid": path} and Path(path) == tmp_path / "port" / "artifacts" / "grid_4.png"
    np.testing.assert_array_equal(read_png(path), image)
    assert set(MetricLogger().memory_stats()) <= {"device_bytes_in_use", "device_peak_bytes", "host_rss_kb"}


def test_log_train_artifacts_matches_jax(tmp_path):
    """The rgb / GT / aligned-prediction grid against JAX's on the same
    maps (GT with invalid pixels, one sample with no valid GT), and without
    GT; the PNG it writes reads back as the grid."""
    rng = np.random.default_rng(4)
    rgbs = [rng.integers(0, 256, (12, 16, 3)).astype(np.float32) for _ in range(3)]
    gts = [rng.uniform(1, 10, (12, 16, 1)).astype(np.float32) for _ in range(3)]
    gts[0][:4] = 0.0
    gts[2][:] = 0.0
    preds = [g * 0.5 + rng.uniform(0, 1, g.shape).astype(np.float32) for g in gts]
    infos = {"error": [rng.uniform(0, 1, (12, 16)).astype(np.float32) for _ in range(3)]}
    for gt_arg, info_arg in ((gts, infos), ([], None)):
        got = log_train_artifacts(rgbs, [torch.from_numpy(g) for g in gt_arg], [torch.from_numpy(p) for p in preds],
                                  out_path=tmp_path / "grid.png", infos=info_arg)
        want = j_log_train_artifacts(rgbs, gt_arg, preds, infos=info_arg)
        assert got.shape == want.shape == ((4 if gt_arg else 2) * 12, 48, 3)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(read_png(tmp_path / "grid.png"), got)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_trainer_validates_each_family_under_the_ema(family):
    """``Trainer.validate`` runs each family's eval forward under the EMA
    shadow: finite depth metrics, and the live weights and the masters
    bitwise what they were."""
    from unidepth_tpu_torch.datasets.loader import eval_batches

    cfg = FAMILIES[family]
    trainer = build_trainer(cfg, device="cpu", seed=3)
    _steps(trainer, cfg, range(1))
    live = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    masters = {n: t.clone() for n, t in trainer.state.params.items()}
    data = Dummy(image_shape=tuple(cfg["data"]["image_shape"]), length=4, seed=1)
    results = trainer.validate({"Dummy": eval_batches(data, 2)})
    assert np.isfinite(list(results["Dummy"].values())).all() and "d1" in results["Dummy"]
    assert all(torch.equal(p, live[n]) for n, p in trainer.model.named_parameters())
    assert all(torch.equal(t, masters[n]) for n, t in trainer.state.params.items())
