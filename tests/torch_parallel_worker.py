"""Multi-process workers for the port's parallel tests (tests/test_torch_parallel_*.py).

Each test file spawns one gloo group of ``WORLD`` CPU processes through
``spawn`` and runs one worker function of this module in every rank; the
rendezvous is a ``file://`` store under the test's ``tmp_path`` (never a
fixed port: several test processes run at once). This module imports torch,
numpy and the port only, so that a spawned rank does not import JAX; each
rank writes what it computed to ``out/rank{r}.pt`` and the test compares
that with the JAX package in its own process.
"""

from __future__ import annotations

import copy
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 2
# every tiny test model's weights fall under the production floor (1 Mi
# elements): the train worker lowers the fsdp rule's floor so that they shard
FSDP_MIN_SIZE = 4096
MODES = {"dp": (2, 1, 1), "fsdp": (1, 2, 1), "tp": (1, 1, 2)}


def spawn(worker, tmp_path: Path, *args) -> list[dict]:
    """Run ``worker(rank, *args)`` in WORLD gloo processes; returns what
    each rank saved (``save``)."""
    out = Path(tmp_path) / "out"
    out.mkdir(parents=True, exist_ok=True)
    mp.spawn(_entry, args=(worker, str(Path(tmp_path) / "store"), str(out), args), nprocs=WORLD, join=True)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _entry(rank, worker, store, out, args):
    from unidepth_tpu_torch.parallel.mesh import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed(backend="gloo", init_method=f"file://{store}", world_size=WORLD, rank=rank)
    try:
        result = worker(rank, *args)
        torch.save(result, Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def take_rows(batch: dict, mesh) -> dict:
    """The mesh rank's rows of a whole (accum, batch, ...) step."""
    local = batch["image"].shape[1] // mesh.batch_shards
    r = mesh.batch_rank
    return {k: v[:, r * local : (r + 1) * local] for k, v in batch.items()}


def train_modes(rank, config: dict, state_dict: dict, batch: dict, ckpt_dir: str) -> dict:
    """One V2 train step under each of dp=2, fsdp=2 and tp=2 through
    ``build_trainer`` (the weights ``state_dict``), every micro-batch with
    the stochastic-depth draw of the first (so that the JAX reference can
    be handed the same masks). Returns each mode's metrics, the whole state
    after the step, the shards' shapes and splits; writes the fsdp state
    through ``save_train_state`` and loads it back under tp."""
    from unidepth_tpu_torch.io.checkpoint import load_train_state, save_train_state
    from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2
    from unidepth_tpu_torch.parallel import mesh as mesh_module
    from unidepth_tpu_torch.parallel.mesh import all_gather_cat, make_mesh
    from unidepth_tpu_torch.training import step as step_module
    from unidepth_tpu_torch.training.trainer import build_trainer

    real_seeds = step_module.micro_seeds
    step_module.micro_seeds = lambda seed, accum: [(real_seeds(seed, accum)[0][0], s) for _, s in
                                                   real_seeds(seed, accum)]

    def init_params(self, seed=0, **kw):
        self.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()})
        return self

    UniDepthV2.init_params = init_params
    mesh_module.FSDP_MIN_SIZE = FSDP_MIN_SIZE
    results = {}
    saved = None
    for mode, (d, f, t) in MODES.items():
        mesh = make_mesh(d, f, t, device="cpu")
        trainer = build_trainer(config, device="cpu", seed=0, mesh=mesh)
        metrics = trainer.step(take_rows(batch, mesh), 0)
        state, layout = trainer.state, trainer.layout
        trees = {"params": state.params, "mu": state.opt_state.mu, "nu": state.opt_state.nu,
                 "shadow": state.ema.shadow}
        whole = {k: layout.full(v) for k, v in trees.items()}
        # tensors whole over tp: the same on both tp ranks after the step
        tp_equal = True
        if t > 1:
            for n, s in layout.splits.items():
                if s.tp is None:
                    both = all_gather_cat(state.params[n][None], mesh.group("tp"))
                    tp_equal &= bool(torch.equal(both[0], both[1]))
        results[mode] = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "whole": whole if rank == 0 else None,
            "shapes": {k: {n: tuple(x.shape) for n, x in v.items()} for k, v in trees.items()},
            "local": {n: tuple(p.shape) for n, p in trainer.model.named_parameters()},
            "splits": dict(layout.splits),
            "counts": (state.step, state.opt_state.count, state.ema.num_updates),
            "tp_equal": tp_equal,
        }
        if mode == "fsdp":
            saved = save_train_state(ckpt_dir, state, layout)
            results[mode]["saved"] = str(saved)
        if mode == "tp":
            reloaded = layout.full(load_train_state(saved, trainer.state, layout).params)  # every rank gathers
            results[mode]["reloaded"] = reloaded if rank == 0 else None
    return results


def forwards_and_serving(rank, tp_models: dict, model, image: np.ndarray, rgbs: np.ndarray, dataset,
                        batch_size: int) -> dict:
    """Each (model, image, kwargs) of ``tp_models`` split over tp=2
    (``shard_model_``), its ``encode_decode`` under no_grad (outputs
    replicated over tp); then, over data=2, ``model``'s batch-sharded
    ``encode_decode`` and ``infer()`` and ``validate()`` on this rank's
    padded shard of ``dataset``."""
    from unidepth_tpu_torch.datasets.loader import eval_batches
    from unidepth_tpu_torch.parallel.mesh import batch_sharded, make_mesh
    from unidepth_tpu_torch.parallel.tp import shard_model_
    from unidepth_tpu_torch.utils.validation import validate

    out = {"tp": {}}
    tp_mesh = make_mesh(1, 1, 2, device="cpu")
    for name, (tp_model, tp_image, kwargs) in tp_models.items():
        tp_model = copy.deepcopy(tp_model).eval()
        splits = shard_model_(tp_model, tp_mesh)
        with torch.no_grad():
            res = tp_model.encode_decode(torch.as_tensor(tp_image),
                                         **{k: torch.as_tensor(v) for k, v in kwargs.items()})
        out["tp"][name] = {"outputs": {k: v for k, v in res.items() if torch.is_tensor(v)},
                           "split": sorted(n for n, s in splits.items() if s.tp is not None)}
    mesh = make_mesh(2, 1, 1, device="cpu")
    model = model.eval()
    with torch.no_grad():
        enc = batch_sharded(model.encode_decode, mesh, torch.as_tensor(image))
        inf = batch_sharded(model.infer, mesh, torch.as_tensor(rgbs))
    batches = list(eval_batches(dataset, batch_size, mesh.batch_shards, mesh.batch_rank))
    out["encode_decode"] = {k: v for k, v in enc.items() if torch.is_tensor(v)}
    out["infer"] = {k: v for k, v in inf.items() if torch.is_tensor(v)}
    out["val"] = validate(model, {"Dummy": iter(batches)}, with_3d=True, depth_ranges={"Dummy": (0.1, 10.0)})
    out["pad_masks"] = [b["pad_mask"] for b in batches]
    return out
