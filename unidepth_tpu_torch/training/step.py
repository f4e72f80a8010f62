"""The training step (counterpart of unidepth_tpu/training/step.py), for one
process and one device.

As in JAX, the master parameters, the Adam moments, the EMA shadow and the
gradient accumulation are float32, and the model computes in its own dtype
(bf16 on the card): at the start of each step the masters are copied into
the model's parameters, each micro-batch's ``.grad`` is added into float32
buffers, and the losses run in float32. ``train_step`` updates the state in
place (the parameters, moments and shadow are large) and returns it.

Accumulation runs over the leading micro-batch axis of the batch, one
forward and backward a micro-batch, then the mean gradient, the global norm
(a metric, and the clipping's norm), one optimizer update and one EMA
update. Random draws (stochastic depth on the model's device, the LocalSSI
buckets on the CPU) come from generators seeded from the step's ``seed``
and the micro-batch index, so a step is a function of its state, its batch
and its seed.

Over several processes (``layout``, a ``parallel.mesh.Layout``) each rank
runs its rows of every micro-batch (the batch split over data x fsdp; tp
peers share rows). The state holds the rank's shards: before the forward
the masters are all-gathered over fsdp into the model; after accumulation
the gradients are averaged over data x fsdp and reduce-scattered over
fsdp (a tensor whole on the tp ranks also averaged over tp, which keeps
its copies equal where a backward kernel's atomics round differently on
each); the global norm sums the squares of the shards over fsdp x tp,
counting a tensor that is whole on several ranks once; the optimizer and
EMA update the shards; the loss metrics are averaged over every rank.
Stochastic depth draws for the whole batch from the shared seed and each
rank takes its rows (``nn.layers.BatchRows``), and LocalSSI's draws use the
same seed on every rank, so a sharded step computes what one process does
on the whole batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import torch.distributed as dist

from unidepth_tpu_torch.nn.layers import BatchRows
from unidepth_tpu_torch.training.ema import EMAState, ema_init, ema_update
from unidepth_tpu_torch.training.losses import build_losses
from unidepth_tpu_torch.training.optim import AdamWState, global_norm
from unidepth_tpu_torch.utils.misc import normalize_rgb

__all__ = ["TrainState", "compute_losses_v1", "compute_losses_v2", "ema_config", "forward_backward", "make_train_step",
           "make_train_step_v1", "master_params", "micro_seeds", "sync_model", "to_device"]


@dataclasses.dataclass
class TrainState:
    params: dict[str, torch.Tensor]  # float32 masters, by the model's parameter names
    opt_state: AdamWState
    ema: EMAState
    step: int


def master_params(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """float32 copies of the model's parameters, on its device."""
    return {n: p.detach().float().clone() for n, p in model.named_parameters()}


@torch.no_grad()
def sync_model(model: torch.nn.Module, state: TrainState, layout=None) -> None:
    """Write the masters into the model through ``load_state_dict``: its
    parameters in their dtype, and the fp32 masters int8 serving quantizes
    from (``ServingPrecisionMixin``). Call it when training ends or
    checkpoints. ``layout``: the masters are shards, gathered first."""
    params = state.params if layout is None else layout.gather(state.params)
    missing, unexpected = model.load_state_dict(params, strict=False)
    params = dict(model.named_parameters())
    if unexpected or any(k in params for k in missing):
        raise ValueError(f"train state does not fit the model: missing {missing}, unexpected {unexpected}")


def compute_losses_v2(losses: dict, outputs: dict, batch: dict, rng: torch.Generator | None) -> dict:
    """V2's loss slots (reference unidepthv2.py:168-237): per slot, the
    weighted batch mean; 'total' is their sum."""
    out = {}
    depth_mask = batch["depth_mask"]
    si, flips = batch.get("si"), batch.get("flips")
    if "depth" in losses:
        l = losses["depth"]
        out["depth"] = l.weight * l(outputs["depth"], batch["depth"], depth_mask, si=si).mean()
    if "camera" in losses:
        l = losses["camera"]
        out["camera"] = l.weight * l(outputs["rays"], batch["rays"]).mean()
    if "invariance" in losses:
        l = losses["invariance"]
        if flips is None:
            flips = torch.zeros(depth_mask.shape[0], dtype=torch.bool, device=depth_mask.device)
        out["invariance"] = l.weight * l(outputs["depth"], intrinsics=batch["K"], mask=depth_mask, flips=flips,
                                         downsample_ratio=1).mean()
    if "ssi" in losses:
        l = losses["ssi"]
        out["ssi"] = l.weight * l(outputs["depth"], batch["depth"], depth_mask, image=batch["image"],
                                  validity_mask=batch.get("validity_mask"), rng=rng).mean()
    if "confidence" in losses:
        l = losses["confidence"]
        out["confidence"] = l.weight * l(torch.log(outputs["confidence"]), target_pred=outputs["depth"],
                                         target_gt=batch["depth"], mask=depth_mask).mean()
    out["total"] = sum(out.values())
    return out


def compute_losses_v1(losses: dict, outputs: dict, batch: dict, rng: torch.Generator | None) -> dict:
    """V1's loss slots (reference unidepthv1.py:235-284): SILog depth, rays
    regression, SelfDistill on the 1/14-scale depth features."""
    out = {}
    depth_mask = batch["depth_mask"]
    si, flips = batch.get("si"), batch.get("flips")
    l = losses["depth"]
    out["depth"] = l.weight * l(outputs["depth"], batch["depth"], depth_mask, si=si).mean()
    l = losses["camera"]
    b = outputs["rays"].shape[0]
    out["camera"] = l.weight * l(outputs["rays"].reshape(b, -1, 3), batch["rays"]).mean()
    if "invariance" in losses:
        l = losses["invariance"]
        if flips is None:
            flips = torch.zeros(b, dtype=torch.bool, device=depth_mask.device)
        out["invariance"] = l.weight * l(outputs["depth_features"], intrinsics=batch["K"], mask=depth_mask,
                                         flips=flips, downsample_ratio=14).mean()
    out["total"] = sum(out.values())
    return out


def ema_config(config: dict) -> dict:
    """The reference's EMA cadence: an update every 10 optimizer steps with
    the folded decay 1 - (1 - 0.9995) * 10; ``update_after_step`` and
    ``tau`` in updates (the step counts / 10)."""
    return dict(decay=1.0 - (1.0 - 0.9995) * 10,
                update_after_step=config["training"].get("warmup_iters", 75000) // 10,
                tau=20000 // 10, every=10)


def micro_seeds(seed, accum: int) -> list[tuple[int, int]]:
    """(stochastic depth, loss) generator seeds for each micro-batch of a
    step with ``seed`` (an int or a sequence of ints, e.g. (run seed,
    step))."""
    return [tuple(int(s) for s in ss.generate_state(2)) for ss in np.random.SeedSequence(seed).spawn(accum)]


def to_device(batch: dict, device) -> dict:
    """The batch's leaves on ``device``: a tensor already there is used as it
    is (``device_prefetch``'s), a numpy array is copied."""
    device = torch.device(device)

    def there(v) -> bool:
        return torch.is_tensor(v) and v.device.type == device.type and device.index in (None, v.device.index)

    return {k: v if there(v) else torch.as_tensor(v).to(device) for k, v in batch.items()}


def forward_backward(model, losses: dict, batch: dict, recipe=compute_losses_v2, norm_mode="imagenet",
                     gen_dp: torch.Generator | None = None, gen_loss: torch.Generator | None = None) -> dict:
    """One micro-batch (tensors on the model's device): the train forward
    (the image normalised on the device, as the JAX step does), the loss
    slots, and the backward, which adds into the parameters' ``.grad``.
    Returns the slots, detached."""
    image = normalize_rgb(batch["image"], norm_mode)
    outputs = model.encode_decode(image, rays_gt=batch.get("rays"), generator=gen_dp)
    ldict = recipe(losses, outputs, batch, gen_loss)
    ldict["total"].backward()
    return {k: v.detach() for k, v in ldict.items()}


def make_train_step(model, optimizer, config: dict, recipe=None, layout=None):
    """Returns (init_state, train_step) for ``model`` (a UniDepthV2, or a
    model with its ``encode_decode``) and ``optimizer`` (``optim.AdamW``).
    ``recipe`` maps (losses, outputs, batch, rng) to the loss dict and
    defaults to V2's slots. ``layout`` (``parallel.mesh.Layout``): the step
    of one rank of a mesh, whose state holds this rank's shards."""
    losses = build_losses(config)
    recipe = recipe or compute_losses_v2
    ema_cfg = ema_config(config)
    norm_mode = config.get("data", {}).get("normalization", "imagenet")
    weights = dict(model.named_parameters())
    names = list(weights)
    device = next(model.parameters()).device

    def init_state(params: dict) -> TrainState:
        if list(params) != names:
            raise ValueError("params must hold the model's parameters, by name, in order")
        return TrainState(params=params, opt_state=optimizer.init(params), ema=ema_init(params), step=0)

    mesh = None if layout is None else layout.mesh
    world_group = None if mesh is None else mesh.group("data", "fsdp", "tp")

    def train_step(state: TrainState, batch: dict, seed) -> tuple[TrainState, dict]:
        """``batch`` leaves are (accum, micro_batch, ...) numpy arrays or
        tensors; a flat (batch, ...) layout is one micro-batch. Over a mesh,
        the rank's rows of the whole batch."""
        batch = to_device(batch, device)
        if batch["image"].ndim == 4:
            batch = {k: v[None] for k, v in batch.items()}
        accum, rows = batch["image"].shape[:2]
        if mesh is not None and "invariance" in losses and rows % 2:
            # SelfDistill pairs rows (2i, 2i + 1): a rank's rows must hold whole pairs
            raise ValueError(f"{rows} rows a rank split the invariance loss's pairs: the batch a rank must be even")
        with torch.no_grad():
            if layout is None:
                for n in names:
                    weights[n].copy_(state.params[n])
            else:
                layout.load_into(weights, state.params)
        grads = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in weights.items()}
        ldicts = []
        for i, (s_dp, s_loss) in enumerate(micro_seeds(seed, accum)):
            gen_dp = torch.Generator(device=device).manual_seed(s_dp)
            if mesh is not None:
                gen_dp = BatchRows(gen_dp, rows * mesh.batch_shards, rows * mesh.batch_rank)
            gen_loss = torch.Generator().manual_seed(s_loss)
            mb = {k: v[i] for k, v in batch.items()}
            ldicts.append(forward_backward(model, losses, mb, recipe, norm_mode, gen_dp, gen_loss))
            for n in names:
                g = weights[n].grad
                if g is not None:
                    grads[n].add_(g.float())
                weights[n].grad = None
        torch._foreach_div_(list(grads.values()), float(accum))
        metrics = {k: torch.stack([d[k] for d in ldicts]).mean() for k in ldicts[0]}
        if layout is None:
            g_norm = global_norm(grads.values())
        else:
            grads = layout.reduce_grads(grads)
            g_norm = layout.global_norm(grads)
            if world_group is not None:  # tp peers hold the same rows: their mean is the same number on every rank
                keys = list(metrics)
                flat = torch.stack([metrics[k].float() for k in keys])
                dist.all_reduce(flat, group=world_group)
                metrics = dict(zip(keys, (flat / mesh.world).unbind(0)))
        metrics["grad_norm"] = g_norm
        optimizer.apply(state.params, grads, state.opt_state, g_norm)
        ema_update(state.ema, state.params, **ema_cfg)
        state.step += 1
        return state, metrics

    return init_state, train_step


def make_train_step_v1(model, optimizer, config: dict, layout=None):
    """``make_train_step`` with V1's loss slots."""
    return make_train_step(model, optimizer, config, recipe=compute_losses_v1, layout=layout)
