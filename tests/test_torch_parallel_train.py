"""The port's V2 train step over two processes (gloo, CPU) against the JAX
package's unsharded step on the whole batch.

A small UniDepthV2 (DINOv2 C = 64, 4 blocks, 2 heads; decoder hidden 64),
the shipped ViT-L/14 config's training section with stochastic depth at
rate 0.3, one seeded ``collate``d Dummy step of 2 x 4 images at 28 x 56.
Two ranks take one step each under dp=2 (2 rows each), fsdp=2 (the
masters, moments and shadow sharded, the size floor lowered to 4096
elements so that the tiny weights shard) and tp=2 (the attention and MLP
projections split, the same 4 rows on both ranks), through
``build_trainer``. Each micro-batch draws the stochastic depth of the first
one (the JAX step draws from its own key, so it is handed the port's masks:
the global-batch draw is what both hold), and the JAX step runs the whole
batch in one process. Gates as tests/test_torch_train_step.py's: loss
slots rtol 1e-5, masters and shadow relative L2 <= 1e-5 a tensor, the Adam
moments at the gradient gates (1e-4, 1e-3 for the LeakyReLU-kinked heads;
twice for the second moment). The masters and shadow are held there on
the elements whose reference gradient is above its rounding level, the
gradient gate's share of the tensor's RMS (``_held``); below it the
gradient gate admits either sign, and Adam's first step, g / (|g| + eps),
turns either into a step of up to lr, so those few elements are held to
within two steps (2 lr) of JAX's. Then the layouts: each rank holds half of
every fsdp-split tensor of masters, mu, nu and shadow on the dim the rule
names; tp-split tensors hold a rank's heads and whole ones agree across
the tp ranks; the fsdp-written checkpoint is the whole state in the
one-process format, loads at world size 1 and re-shards under tp.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parallel_worker import FSDP_MIN_SIZE, MODES, spawn, train_modes
import torch_threads  # noqa: F401  (sets this process's torch thread count)

import unidepth_tpu.nn.layers as j_layers
from unidepth_tpu.io.convert import convert_v2_state_dict
from unidepth_tpu.models.unidepthv2.model import UniDepthV2 as JUniDepthV2
from unidepth_tpu.training.optim import build_optimizer as j_build_optimizer
from unidepth_tpu.training.step import make_train_step as j_make_train_step
from unidepth_tpu_torch.datasets.dummy import Dummy
from unidepth_tpu_torch.datasets.loader import make_batch
from unidepth_tpu_torch.io.checkpoint import load_train_state
from unidepth_tpu_torch.io.convert import from_jax_train_state
from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2
from unidepth_tpu_torch.parallel import mesh as mesh_module
from unidepth_tpu_torch.parallel.mesh import fsdp_param_sharding, param_layouts, tp_param_sharding
from unidepth_tpu_torch.training.step import micro_seeds
from unidepth_tpu_torch.training.trainer import build_trainer

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (28, 56)
BATCH, ACCUM, RATE = 4, 2, 0.3
BATCH_SEED = 1


def tiny_config() -> dict:
    cfg = json.loads((ROOT / "configs/config_v2_vitl14.json").read_text())
    cfg["model"]["num_heads"] = 2
    cfg["model"]["pixel_decoder"].update(hidden_dim=64, out_dim=16, depths=[1, 1, 1])
    cfg["model"]["pixel_encoder"].update(name="dinov2_vits14", embed_dim=64, depth=4, num_heads=2, pos_embed_size=4,
                                         output_idx=[1, 2, 3, 4], drop_path=RATE)
    cfg["training"].update(batch_size=BATCH, nsteps_accumulation_gradient=ACCUM, warmup_iters=3, n_iters=20)
    cfg["data"]["image_shape"] = list(SHAPE)
    return cfg


CFG = tiny_config()
KINKED = tuple(f"pixel_decoder.depth_layer.{m}." for m in (
    "depth_mlp", "to_depth_lr", "to_depth_hr.0", "confidence_mlp", "to_confidence_lr", "to_confidence_hr.0"))


def _grad_gate(name: str) -> float:
    return 1e-3 if name.startswith(KINKED) else 1e-4


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    den = want.double().norm().item()
    diff = (got.double() - want.double()).norm().item()
    return diff / den if den > 0 else diff


def _held(name: str, mu: torch.Tensor) -> torch.Tensor:
    """The elements whose reference gradient (the first moment after one
    step, (1 - b1) g) is at least the gradient gate's share of the tensor's
    RMS: a gradient below it may take either sign within the gate."""
    g = mu.double().abs()
    return g >= _grad_gate(name) * g.square().mean().sqrt()


def _port_masks(depth: int) -> np.ndarray:
    """The keep masks (depth, 2 branches, BATCH) the port's step draws over
    the whole batch: block j's from the stochastic-depth seed of micro-batch
    0, for the blocks of positive rate; block 0 (rate 0) keeps all."""
    gen = torch.Generator().manual_seed(micro_seeds(0, ACCUM)[0][0])
    rates = np.linspace(0.0, RATE, depth)
    masks = np.ones((depth, 2, BATCH), bool)
    for j, rate in enumerate(rates):
        if rate > 0.0:
            masks[j] = (torch.rand((2, BATCH), generator=gen) < 1.0 - float(rate)).numpy()
    return masks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX step's new state and metrics, the ranks' results, the names,
    the fsdp checkpoint). The weights: the port's init plus noise, carried to
    JAX by the reference-schema converter."""
    tmp = tmp_path_factory.mktemp("parallel_train")
    tm = UniDepthV2.from_config(CFG, device="cpu").init_params(seed=0)
    rng = np.random.default_rng(0)
    sd = {k: (v.numpy() + 0.02 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in tm.state_dict().items()}
    batch = make_batch(Dummy(image_shape=SHAPE, length=64), BATCH, ACCUM, np.random.default_rng(BATCH_SEED))
    ranks = spawn(train_modes, tmp, CFG, sd, batch, str(tmp / "ckpt"))

    jm = JUniDepthV2.from_config(CFG, dtype=jnp.float32)
    jm.params = convert_v2_state_dict(sd, output_idx=(1, 2, 3, 4), num_levels=3, use_norm=True)
    masks, rates = _port_masks(4), np.linspace(0.0, RATE, 4).astype(np.float32)
    calls = [0]

    def port_drop_path(x, rate, rng, deterministic=True):
        """The JAX drop_path with the port's masks: the block from its rate,
        the branch from the call order (attention, then MLP)."""
        if deterministic:
            return x
        branch, calls[0] = calls[0] % 2, calls[0] + 1
        keep = 1.0 - jnp.asarray(rate, jnp.float32)
        block = jnp.argmin(jnp.abs(jnp.asarray(rates) - rate))
        mask = jnp.asarray(masks)[block, branch].reshape((x.shape[0],) + (1,) * (x.ndim - 1))
        return jnp.where(mask, x / keep.astype(x.dtype), jnp.zeros((), x.dtype))

    tr = CFG["training"]
    kw = dict(lr=tr["lr"], lr_final=tr["lr_final"], encoder_lr=2e-6, wd=tr["wd"], wd_final=tr["wd_final"],
              warmup_iters=tr["warmup_iters"], total_iters=tr["n_iters"], ld=tr["ld"], num_encoder_layers=4,
              clipping=tr["clipping"], cycle_betas=tr["cycle_beta"])
    j_init, j_step = j_make_train_step(jm, j_build_optimizer(jm.params, **kw), CFG)
    real = j_layers.drop_path
    j_layers.drop_path = port_drop_path
    try:
        j_new, j_metrics = jax.jit(j_step)(j_init(jm.params), {k: jnp.asarray(v) for k, v in batch.items()},
                                           jax.random.key(0))
    finally:
        j_layers.drop_path = real
    assert calls[0] > 0 and calls[0] % 2 == 0  # the JAX step took the port's masks
    names = [n for n, _ in tm.named_parameters()]
    return from_jax_train_state(j_new, CFG, names), j_metrics, ranks, names


@pytest.mark.parametrize("mode", list(MODES))
def test_sharded_step_matches_jax_unsharded(runs, mode):
    ref, j_metrics, ranks, names = runs
    got = ranks[0][mode]
    assert got["counts"] == ranks[1][mode]["counts"] == (1, 1, 1)
    assert ranks[0][mode]["metrics"] == ranks[1][mode]["metrics"]  # all-reduced
    for k in j_metrics:
        np.testing.assert_allclose(got["metrics"][k], float(j_metrics[k]), rtol=1e-5, err_msg=k)
    whole = got["whole"]
    lr = CFG["training"]["lr"]
    loose = total = 0
    for n in names:
        held = _held(n, ref.opt_state.mu[n])
        loose, total = loose + int((~held).sum()), total + held.numel()
        for tree, want in (("params", ref.params[n]), ("shadow", ref.ema.shadow[n])):
            assert _rel_l2(whole[tree][n][held], want[held]) <= 1e-5, (tree, n)
            assert (whole[tree][n][~held] - want[~held]).abs().le(2 * lr).all(), (tree, n)
        assert _rel_l2(whole["mu"][n], ref.opt_state.mu[n]) <= _grad_gate(n), n
        assert _rel_l2(whole["nu"][n], ref.opt_state.nu[n]) <= 2 * _grad_gate(n), n
    assert loose <= total // 1000, (loose, total)  # the rule leaves out a few elements, not a tensor


def test_fsdp_shards_are_halves_on_the_rule_dim(runs, monkeypatch):
    """Each rank's masters, mu, nu and shadow: half of every tensor the rule
    splits, on its dim; the rest whole. The split is the rule's on the
    port's parameters, at the ranks' lowered size floor."""
    _, _, ranks, names = runs
    monkeypatch.setattr(mesh_module, "FSDP_MIN_SIZE", FSDP_MIN_SIZE)
    whole_shapes = ranks[0]["dp"]["shapes"]["params"]
    splits = ranks[0]["fsdp"]["splits"]
    layouts = param_layouts(UniDepthV2.from_config(CFG, device="cpu"))
    assert splits == fsdp_param_sharding({"fsdp": 2}, whole_shapes, layouts)
    n_split = 0
    for n in names:
        d = splits[n].fsdp
        for rank in ranks:
            for tree in ("params", "mu", "nu", "shadow"):
                shape = rank["fsdp"]["shapes"][tree][n]
                want = list(whole_shapes[n])
                if d is not None:
                    want[d] //= 2
                assert shape == tuple(want), (n, tree)
        n_split += d is not None
    assert n_split > len(names) // 4


def test_tp_layout_and_replicas(runs):
    _, _, ranks, names = runs
    got = ranks[0]["tp"]
    split = {n: s for n, s in got["splits"].items() if s.tp is not None}
    assert {n.rsplit(".", 2)[-2] for n in split} == {"qkv", "proj", "fc1", "fc2", "q", "kv", "out", "proj1", "proj2"}
    whole = ranks[0]["dp"]["shapes"]["params"]
    for n, s in split.items():
        want = list(whole[n])
        want[s.tp] //= 2
        assert got["local"][n] == tuple(want), n
    layouts = param_layouts(UniDepthV2.from_config(CFG, device="cpu"))
    # the patch embedding, a conv named like a row-parallel projection, stays whole
    assert got["splits"] == tp_param_sharding({"tp": 2}, whole, layouts=layouts, whole={"pixel_encoder.patch_embed.proj"})
    assert all(r["tp"]["tp_equal"] for r in ranks)


def test_fsdp_checkpoint_loads_at_world_size_1_and_under_tp(runs):
    """Rank 0 wrote the whole state in the one-process format: it loads into
    a one-process trainer and equals the gathered state; the tp run cut its
    shards from it and gathers back the same tensors."""
    _, _, ranks, names = runs
    saved = ranks[0]["fsdp"]["saved"]
    assert Path(saved).is_file() and ranks[1]["fsdp"]["saved"] == saved
    single = build_trainer(CFG, device="cpu", seed=3)
    state = load_train_state(saved, single.state)
    whole = ranks[0]["fsdp"]["whole"]
    assert state.step == 1
    for n in names:
        assert torch.equal(state.params[n], whole["params"][n]), n
        assert torch.equal(state.opt_state.nu[n], whole["nu"][n]), n
        assert torch.equal(ranks[0]["tp"]["reloaded"][n], whole["params"][n]), n
