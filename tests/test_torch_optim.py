"""The port's schedules, optimizer groups, AdamW chain and EMA against the JAX
package (optax) on the CPU. Parameter trees are those of a small UniDepthV2,
carried between the packages by ``convert_v2_state_dict`` and
``from_jax_params``; V2's ``level_embeds`` is a buffer in the port (JAX
gives it a zero gradient and no decay, so it never moves there either)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_threads  # noqa: F401  (sets this process's torch thread count)

from unidepth_tpu.io.convert import convert_v2_state_dict
from unidepth_tpu.training.ema import ema_init as j_ema_init
from unidepth_tpu.training.ema import ema_update as j_ema_update
from unidepth_tpu.training.optim import build_optimizer as j_build_optimizer
from unidepth_tpu.training.optim import lr_scale_tree as j_lr_scale_tree
from unidepth_tpu.training.optim import wd_mask_tree as j_wd_mask_tree
from unidepth_tpu.training.schedules import betas_schedule as j_betas
from unidepth_tpu.training.schedules import cosine_warmup as j_cosine
from unidepth_tpu_torch.io.convert import from_jax_params, from_jax_train_state
from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2, get_params_info
from unidepth_tpu_torch.training.ema import ema_init, ema_update
from unidepth_tpu_torch.training.optim import build_optimizer, lr_scale_tree, wd_mask_tree
from unidepth_tpu_torch.training.schedules import betas_schedule, cosine_warmup

CFG = {
    "model": {
        "name": "UniDepthV2", "num_heads": 2,
        "pixel_decoder": {"hidden_dim": 64, "out_dim": 16, "depths": [1, 1, 1]},
        "pixel_encoder": {
            "name": "dinov2_vits14", "embed_dim": 64, "depth": 4, "num_heads": 2,
            "pos_embed_size": 4, "output_idx": [1, 2, 3, 4], "use_norm": True, "lr": 3e-6,
        },
    },
    "training": {"lr": 1e-4, "ld": 0.9},
}
DEPTH = 4


@pytest.fixture(scope="module")
def trees():
    """(JAX params, the port's parameter names)."""
    model = UniDepthV2.from_config(CFG, device="cpu").init_params(seed=0)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params = convert_v2_state_dict(sd, output_idx=(1, 2, 3, 4), num_levels=3, use_norm=True)
    return params, [n for n, _ in model.named_parameters()]


def _port(tree, names):
    sd = from_jax_params(tree, CFG)
    return {n: sd[n] for n in names}


@pytest.mark.parametrize("args", [(1e-4, 1e-6, 10, 100, None), (1e-4, 1e-6, 10, 100, 1e-5), (0.1, 0.1, 0, 50, None),
                                  (0.85, 0.95, 7, 30, 0.95)])
def test_cosine_warmup_endpoints_and_midpoints(args):
    base, final, warmup, total, init = args
    j, t = j_cosine(base, final, warmup, total, init), cosine_warmup(base, final, warmup, total, init)
    for step in sorted({0, max(warmup - 1, 0), warmup // 2, warmup, (warmup + total) // 2, total - 1, total, total + 5}):
        got, want = t(step), j(jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, err_msg=f"step {step}")


@pytest.mark.parametrize("cycle", [True, False])
def test_betas_schedule(cycle):
    j, t = j_betas(cycle, 10, 40), betas_schedule(cycle, 10, 40)
    for step in (0, 5, 9, 10, 25, 40, 41):
        np.testing.assert_allclose(float(t(step)), float(j(jnp.asarray(step, jnp.int32))), rtol=1e-6)


@pytest.mark.parametrize("ld", [1.0, 0.9])
def test_groups_match_the_jax_trees(trees, ld):
    """JAX's per-leaf lr scales and decay mask, broadcast to the leaves and
    mapped to the port's names, are the port's groups."""
    params, names = trees
    scale = 3e-6 / 1e-4
    j_scales = jax.tree.map(lambda s, x: np.broadcast_to(np.asarray(s, np.float32), x.shape),
                            j_lr_scale_tree(params, scale, ld, DEPTH), params)
    j_mask = jax.tree.map(lambda m, x: np.broadcast_to(np.asarray(m, np.float32), x.shape), j_wd_mask_tree(params), params)
    t_params = _port(params, names)
    t_scales, t_mask = lr_scale_tree(t_params, scale, ld, DEPTH), wd_mask_tree(t_params)
    want_scales, want_mask = _port(j_scales, names), _port(j_mask, names)
    for n in names:
        np.testing.assert_allclose(np.full(t_params[n].shape, t_scales[n], np.float32), want_scales[n].numpy(),
                                   rtol=1e-6, err_msg=n)
        assert np.all(want_mask[n].numpy() == float(t_mask[n])), n
    if ld != 1.0:  # the ramp reaches the blocks, the final norm and the embeddings differently
        # embeddings ld^4, blocks ld^3 .. ld^0, the final norm ld^0
        assert len({t_scales[n] for n in names if n.startswith("pixel_encoder.")}) == DEPTH + 1


def test_get_params_info_reads_the_config(trees):
    _, names = trees
    model = UniDepthV2.from_config(CFG, device="cpu")
    scales, mask = get_params_info(model, CFG)
    assert list(scales) == names == list(mask)
    assert scales["pixel_decoder.depth_layer.to_latents.weight"] == 1.0
    np.testing.assert_allclose(scales["pixel_encoder.blocks.3.mlp.fc1.weight"], 0.03)
    np.testing.assert_allclose(scales["pixel_encoder.blocks.0.mlp.fc1.weight"], 0.03 * 0.9**3)
    assert mask["pixel_encoder.blocks.0.mlp.fc1.weight"] and not mask["pixel_encoder.pos_embed"]


@pytest.mark.parametrize("ld,cycle", [(1.0, False), (0.9, True)])
def test_three_steps_match_the_optax_chain(trees, ld, cycle):
    """Three updates on the same gradients (the second one small enough to
    pass the clipping untouched): params, moments and count at rtol 1e-6,
    with an absolute floor of 1e-6 x max |ref| a tensor (the clipping's
    global norm sums the leaves in another order, and a moment that
    cancels to near zero carries that rounding)."""
    params, names = trees
    kw = dict(lr=1e-3, lr_final=1e-5, encoder_lr=1e-4, wd=0.05, wd_final=0.01, warmup_iters=2, total_iters=6, ld=ld,
              num_encoder_layers=DEPTH, clipping=1.0, cycle_betas=cycle, lr_warmup=0.1)
    j_opt = j_build_optimizer(params, **kw)
    j_state = j_opt.init(params)
    j_update = jax.jit(j_opt.update)
    t_params = _port(params, names)
    t_params = {n: p.clone() for n, p in t_params.items()}
    t_opt = build_optimizer(t_params, **kw)
    t_state = t_opt.init(t_params)
    rng = np.random.default_rng(0)
    j_params = params
    for step, norm in enumerate((5.0, 0.3, 2.0)):
        grads = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), j_params)
        grads["decoder"]["level_embeds"] = np.zeros_like(grads["decoder"]["level_embeds"])  # unused by the forward
        total = np.sqrt(sum(float(np.sum(np.square(g))) for g in jax.tree.leaves(grads)))
        grads = jax.tree.map(lambda g: (g * (norm / total)).astype(np.float32), grads)
        updates, j_state = j_update(grads, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        t_opt.apply(t_params, _port(grads, names), t_state)
    adam = next(s for s in j_state.inner_state if hasattr(s, "mu"))
    assert t_state.count == int(adam.count) == 3
    for got, want in ((t_params, _port(j_params, names)), (t_state.mu, _port(adam.mu, names)),
                      (t_state.nu, _port(adam.nu, names))):
        for n in names:
            w = want[n].numpy()
            np.testing.assert_allclose(got[n].numpy(), w, rtol=1e-6, atol=1e-6 * np.abs(w).max(), err_msg=n)


@pytest.mark.parametrize("every,after,tau", [(10, 1, 3), (1, 4, 5)])
def test_ema_ramp_and_interval_gating(every, after, tau):
    """40 updates against ``ema_update``: the shadow stays off the interval,
    takes the parameters before the ramp, then follows the tanh ramp."""
    rng = np.random.default_rng(every)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32), "b": rng.standard_normal(5).astype(np.float32)}
    j_state = j_ema_init(params)
    t_state = ema_init({k: torch.from_numpy(v) for k, v in params.items()})
    for _ in range(40):
        params = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        j_state = j_ema_update(j_state, params, decay=0.9, update_after_step=after, tau=tau, every=every)
        ema_update(t_state, {k: torch.from_numpy(v) for k, v in params.items()}, decay=0.9, update_after_step=after,
                   tau=tau, every=every)
        assert t_state.num_updates == int(j_state.num_updates)
        for k in params:
            # a few ulp of the O(1) values: XLA may fuse the update into one FMA
            np.testing.assert_allclose(t_state.shadow[k].numpy(), np.asarray(j_state.shadow[k]), rtol=1e-6, atol=1e-6)


def test_train_state_carries_across(trees):
    """``from_jax_train_state`` maps params, moments, counts and the shadow."""
    from unidepth_tpu.training.step import TrainState as JTrainState

    params, names = trees
    opt = j_build_optimizer(params, num_encoder_layers=DEPTH)
    grads = jax.tree.map(lambda x: jnp.full(x.shape, 0.01, jnp.float32), params)
    _, opt_state = jax.jit(opt.update)(grads, opt.init(params), params)
    state = JTrainState(params=params, opt_state=opt_state, ema=j_ema_init(params), step=jnp.asarray(7, jnp.int32))
    t = from_jax_train_state(state, CFG, names)
    assert t.step == 7 and t.opt_state.count == 1 and t.ema.num_updates == 0
    assert list(t.params) == names == list(t.opt_state.mu) == list(t.ema.shadow)
    want_mu = _port(next(s for s in opt_state.inner_state if hasattr(s, "mu")).mu, names)
    for n in names:
        assert torch.equal(t.opt_state.mu[n], want_mu[n]) and torch.equal(t.params[n], t.ema.shadow[n])
