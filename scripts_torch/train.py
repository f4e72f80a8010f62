#!/usr/bin/env python3
"""Train UniDepthV1 (ViT or ConvNeXt), UniDepthV2 or UniDepthV2old with the
PyTorch port, on one device or on several processes.

    python3 scripts_torch/train.py --config-file CONFIG (--data-root DIR | --dummy-data) --steps N \\
        [--seed 13] [--image-shape H W] [--checkpoint-dir checkpoints] [--resume PATH] [--device cpu] \\
        [--val-interval N] [--val-iters 25] [--fsdp F] [--tp T]
    python3 -m torch.distributed.run --nproc_per_node N scripts_torch/train.py ... [--fsdp F] [--tp T]

The counterpart of scripts/train.py. One process trains on the card unless
``--device`` names another (without a card and without ``--device cpu`` it
raises). Under ``torch.distributed.run`` (or SLURM / Open MPI) the
processes join one group (``parallel.mesh.initialize_distributed``; backend
``nccl`` on the card, ``gloo`` with ``--device cpu``) and
form a data x fsdp x tp mesh (``--fsdp``, ``--tp``; data takes the rest of
the world size), each process on the card ``LOCAL_RANK`` (or on
``--device``). The global batch ``batch_size`` must divide by data x fsdp
(``check_batch_divisibility``, at start-up); each rank trains its rows,
tp peers the same ones. ``--tp`` splits the attention and MLP projections
Megatron-style (``parallel.tp``); ``--fsdp`` shards the float32 masters,
Adam moments and EMA shadow. Only rank 0 prints, logs, writes artifacts and
writes checkpoints, which hold the whole state in the one-process format:
a run resumes under any mesh, or in one process.

The config's ``model.name`` picks the family and its recipe (V1's loss
slots for UniDepthV1, V2's for V2 and V2old). Random weights
(``init_params(seed)``), the config's training section (losses, AdamW with
its schedules, clipping, EMA, ``batch_size`` x
``nsteps_accumulation_gradient``), the image shape floored to multiples of
14 (UniDepthV1 is built at it).

Data: the config's ``data.train_datasets``, HDF5 shards under
``--data-root`` (default: ``$DATAROOT``; h5py is needed, and PIL for JPEG
images), mixed by ``WeightedConcat`` (``data.sampling`` multipliers),
decoded and augmented by a ``Loader`` of 4 threads, a new image shape each
batch from a ``ShapeSampler`` over the shape constraints for UniDepthV2 and
V2old (``shape_constraints.sample``; UniDepthV1 is fixed-shape), batches
moved to the rank's device through pinned memory two ahead
(``device_prefetch``). Over several ranks each draws its own samples (seed
+ its batch rank) at the shape every rank draws (shape seed: the seed).
``--dummy-data`` trains on the synthetic Dummy set instead, step n's whole
batch a function of (seed, n), each rank taking its rows. Every
``--val-interval`` steps (default: ``training.validation_interval``, 0 or
absent: never) it validates under the EMA shadow, at most ``--val-iters``
batches of each of ``data.val_datasets`` (test mode; Dummy without them or
with ``--dummy-data``), each rank its shard padded to whole batches, and
prints a ``{"val": ...}`` line of the depth metrics.

Prints one JSON line a step (step, the loss slots, grad_norm, lr, seconds)
and, on the card, the peak device memory. Through ``utils.logging.
MetricLogger`` it writes the same records, the validation metrics and the
memory figures to ``<checkpoint-dir>/<config name>.jsonl``, and at every
validation and at the last step the training-artifact grid (rgb, GT, the
EMA model's aligned prediction; ``utils.visualization.log_train_artifacts``)
as a PNG under ``<checkpoint-dir>/artifacts``. Saves the whole train state
to ``--checkpoint-dir`` every ``training.checkpoint_interval`` steps and at
the end; ``--resume`` continues from such a file, bit for bit on the CPU.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--dummy-data", action="store_true", help="train on the synthetic Dummy dataset")
    ap.add_argument("--data-root", default=os.environ.get("DATAROOT"),
                    help="the directory of the HDF5 shards (default: $DATAROOT)")
    ap.add_argument("--steps", type=int, default=None, help="optimizer steps in all (default: training.n_iters)")
    ap.add_argument("--seed", type=int, default=13)
    ap.add_argument("--image-shape", type=int, nargs=2, default=None, help="override data.image_shape")
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--resume", default=None, help="a train-state file written by this script")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--val-interval", type=int, default=None,
                    help="validate every N steps (default: training.validation_interval; 0 disables)")
    ap.add_argument("--val-iters", type=int, default=25, help="at most this many batches a validation")
    ap.add_argument("--fsdp", type=int, default=1, help="shard masters, moments and EMA over this many ranks")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: Megatron column/row splits of the attention and MLP projections "
                         "over the mesh's innermost axis")
    return ap.parse_args(argv)


def data_root(args) -> str:
    """``--data-root`` (or ``$DATAROOT``), which must be a directory."""
    if not args.data_root:
        raise SystemExit("scripts_torch/train.py: no data root: pass --data-root DIR (or set DATAROOT) for the "
                         "config's data.train_datasets, or --dummy-data")
    if not Path(args.data_root).is_dir():
        raise SystemExit(f"scripts_torch/train.py: data root {args.data_root} is not a directory")
    return args.data_root


def shape_sampler(config: dict, model):
    """UniDepthV2's and V2old's per-batch shapes (the model's shape
    constraints, V2old's from the config), when the config samples them;
    None for the fixed-shape UniDepthV1."""
    from unidepth_tpu_torch.datasets.loader import ShapeSampler
    from unidepth_tpu_torch.models.unidepthv2.model import DEFAULT_SHAPE_CONSTRAINTS

    given = config["data"].get("augmentations", {}).get("shape_constraints", {})
    if config["model"].get("name", "UniDepthV2") == "UniDepthV1" or not given.get("sample", False):
        return None
    sc = getattr(model, "shape_constraints", None) or {**DEFAULT_SHAPE_CONSTRAINTS, **given}
    return ShapeSampler({"ratio_bounds": tuple(sc["ratio_bounds"]), "pixels_min": sc["pixels_min"],
                         "pixels_max": sc["pixels_max"], "shape_mult": sc.get("shape_mult", 14)})


def log_artifacts(trainer, logger, name: str, batch: dict, step: int) -> str | None:
    """The EMA model's prediction on the first (at most 4) images of a
    validation batch of ``name``, gridded with their rgb and GT, through the
    logger (None: a rank that runs the forward with the others and writes
    nothing)."""
    import torch

    from unidepth_tpu_torch.training.ema import ema_weights
    from unidepth_tpu_torch.utils.misc import normalize_rgb
    from unidepth_tpu_torch.utils.visualization import log_train_artifacts

    n = min(4, batch["image"].shape[0])
    device = next(trainer.model.parameters()).device
    image, rays = (torch.as_tensor(batch[k][:n]).to(device) for k in ("image", "rays"))
    with ema_weights(trainer.model, trainer.state.ema, trainer.layout), torch.inference_mode():
        depth = trainer.model.encode_decode(normalize_rgb(image.float()), rays_gt=rays)["depth"]
    if logger is None:
        return None
    grid = log_train_artifacts([batch["image"][i] for i in range(n)], [batch["depth"][i] for i in range(n)],
                               [depth[i] for i in range(n)])
    return logger.log_image(f"{name}_training", grid, step)


def take_rows(batch: dict, rows: slice, accum: int) -> dict:
    """A rank's rows of a whole step's batch (leaves (accum, batch, ...), or
    (batch, ...) when ``accum`` is 1)."""
    return {k: v[:, rows] if accum > 1 else v[rows] for k, v in batch.items()}


def main(argv=None):
    args = parse_args(argv)
    import torch
    import torch.distributed as dist

    from unidepth_tpu_torch.datasets.base import make_dataset
    from unidepth_tpu_torch.datasets.dummy import Dummy
    from unidepth_tpu_torch.datasets.loader import Loader, WeightedConcat, device_prefetch, eval_batches, make_batch
    from unidepth_tpu_torch.io.checkpoint import load_train_state, save_train_state
    from unidepth_tpu_torch.parallel.mesh import check_batch_divisibility, initialize_distributed, make_mesh
    from unidepth_tpu_torch.training.trainer import build_trainer, train_image_shape
    from unidepth_tpu_torch.utils.logging import MetricLogger

    config = json.loads(Path(args.config_file).read_text())
    tr = config["training"]
    root = None if args.dummy_data else data_root(args)
    names = [] if args.dummy_data else config["data"].get("train_datasets")
    if root and not names:
        raise SystemExit(f"scripts_torch/train.py: {args.config_file} names no data.train_datasets")
    if args.device is None and not torch.cuda.is_available():
        raise SystemExit("scripts_torch/train.py: no CUDA device; pass --device cpu to train on the CPU")
    backend = "gloo" if args.device and torch.device(args.device).type == "cpu" else "nccl"
    joined = initialize_distributed(backend=backend)
    mesh = make_mesh(fsdp=args.fsdp, tp=args.tp, device=args.device) if joined or args.fsdp * args.tp > 1 else None
    lead = mesh is None or dist.get_rank() == 0
    shards, rank = (1, 0) if mesh is None else (mesh.batch_shards, mesh.batch_rank)
    batch_size, accum = tr.get("batch_size", 8), tr.get("nsteps_accumulation_gradient", 1)
    local_bs = check_batch_divisibility(batch_size, shards, shards)
    image_shape = train_image_shape(config, args.image_shape)
    trainer = build_trainer(config, device=args.device, seed=args.seed, image_shape=args.image_shape, mesh=mesh)
    device = next(trainer.model.parameters()).device

    def say(text):
        if lead:
            print(text, flush=True)

    if args.resume:
        trainer.state = load_train_state(args.resume, trainer.state, trainer.layout)
        say(f"resumed from {args.resume} at step {trainer.state.step}")
    num_copies = config["data"].get("num_copies", 1)
    sampler = None if args.dummy_data else shape_sampler(config, trainer.model)
    family = f"{type(trainer.model).__name__} ({config['model']['pixel_encoder']['name']})"
    shapes = f"shapes {sampler.shapes}" if sampler else f"{image_shape[0]}x{image_shape[1]}"
    grid = "one device (1 process)" if mesh is None else (
        f"{mesh.world} processes ({backend}), mesh data {mesh.shape['data']} x fsdp {mesh.shape['fsdp']} x "
        f"tp {mesh.shape['tp']}, {local_bs} images a rank")
    say(f"training {family} on {device} ({next(trainer.model.parameters()).dtype} compute, fp32 masters), "
        f"{batch_size} x {accum} images a step at {shapes} from {names or 'Dummy'}; {grid}")
    logger = MetricLogger(run_name=Path(args.config_file).stem, out_dir=args.checkpoint_dir) if lead else None
    val_names = [] if args.dummy_data else config["data"].get("val_datasets", [])
    val_sets = ({n: make_dataset(n, data_root=root, test_mode=True, image_shape=image_shape) for n in val_names}
                or {"Dummy": Dummy(image_shape=image_shape, length=2 * batch_size)})

    def val_batches(ds):
        return eval_batches(ds, local_bs, shards, rank, pad=True)

    val_every = tr.get("validation_interval", 0) if args.val_interval is None else args.val_interval
    n_iters = args.steps or tr.get("n_iters", 300000)
    every = tr.get("checkpoint_interval", 10000)
    loader = None
    if args.dummy_data:
        dataset = Dummy(image_shape=image_shape, length=1024)
    else:
        datasets = [make_dataset(n, data_root=root, image_shape=image_shape,
                                 augmentations=config["data"].get("augmentations", {})) for n in names]
        # each rank its own samples, every rank the same shape a batch
        loader = Loader(WeightedConcat(datasets, sampling=config["data"].get("sampling")), batch_size=local_bs,
                        shape_sampler=sampler, accum=accum, num_threads=4, seed=args.seed + rank,
                        num_copies=num_copies, shape_seed=args.seed)
        batches = device_prefetch(loader, device, size=2)
    saved = None
    try:
        while trainer.state.step < n_iters:
            step = trainer.state.step
            if loader is None:
                # Dummy: the whole batch and the draws of step n depend on (seed, n) alone, so a resumed run (on
                # any mesh) repeats them; each rank takes its rows
                batch = make_batch(dataset, batch_size, accum, np.random.default_rng([args.seed, step]), num_copies)
                batch = take_rows(batch, slice(rank * local_bs, (rank + 1) * local_bs), accum)
            else:
                batch = next(batches)
            lr = trainer.optimizer.hyperparams(trainer.state.opt_state.count)["lr"]
            t0 = time.perf_counter()
            metrics = trainer.step(batch, (args.seed, step))
            values = {k: float(v) for k, v in metrics.items()}
            line = {"step": step + 1, **values, "lr": lr, "seconds": time.perf_counter() - t0}
            say(json.dumps(line))
            if logger:
                logger.log({**values, "lr": lr}, step + 1)
            if not all(np.isfinite(list(values.values()))):
                raise SystemExit(f"scripts_torch/train.py: non-finite metrics at step {step + 1}")
            validating = bool(val_every) and trainer.state.step % val_every == 0
            if validating or trainer.state.step == n_iters:
                name, val_set = next(iter(val_sets.items()))
                log_artifacts(trainer, logger, name, next(val_batches(val_set)), trainer.state.step)
            if validating:
                results = trainer.validate({n: val_batches(ds) for n, ds in val_sets.items()},
                                           max_iters=args.val_iters)
                for name, val in results.items():
                    if logger:
                        logger.log({f"{name}/{k}": v for k, v in val.items()}, trainer.state.step, prefix="val")
                say(json.dumps({"step": trainer.state.step, "val": results}))
            if trainer.state.step % every == 0 or trainer.state.step == n_iters:
                trainer.sync_model()
                saved = save_train_state(args.checkpoint_dir, trainer.state, trainer.layout)
                if logger:
                    logger.log(logger.memory_stats(), trainer.state.step, prefix="sys")
                say(f"saved {saved}")
    finally:
        if loader is not None:
            loader.close()
    if device.type == "cuda":
        say(f"peak device memory {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    if logger:
        logger.close()
    if joined:
        dist.destroy_process_group()
    say("done")
    return saved


if __name__ == "__main__":
    main()
