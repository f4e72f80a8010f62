#!/usr/bin/env python3
"""Train UniDepthV1 (ViT or ConvNeXt), UniDepthV2 or UniDepthV2old with the
PyTorch port on one device.

    python3 scripts_torch/train.py --config-file configs/config_v1_cnvnxtl.json --dummy-data --steps N \\
        [--seed 13] [--image-shape H W] [--checkpoint-dir checkpoints] [--resume PATH] [--device cpu] \\
        [--val-interval N] [--val-iters 25]

The counterpart of scripts/train.py for one process and one device: the
card unless ``--device`` names another (without a card and without
``--device cpu`` it raises). The config's ``model.name`` picks the family
and its recipe (V1's loss slots for UniDepthV1, V2's for V2 and V2old).
Random weights (``init_params(seed)``), the config's training section
(losses, AdamW with its schedules, clipping, EMA, ``batch_size`` x
``nsteps_accumulation_gradient``), the image shape floored to multiples of
14 (UniDepthV1 is built at it). Data: ``--dummy-data`` only; the real
datasets wait for ROADMAP A8. It does not shard (A8). Every
``--val-interval`` steps (default: ``training.validation_interval``, 0 or
absent: never) it validates under the EMA shadow on a Dummy set of two
batches, at most ``--val-iters`` batches, and prints a ``{"val": ...}`` line
of the depth metrics.

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
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--dummy-data", action="store_true", help="train on the synthetic Dummy dataset (the only source)")
    ap.add_argument("--steps", type=int, default=None, help="optimizer steps in all (default: training.n_iters)")
    ap.add_argument("--seed", type=int, default=13)
    ap.add_argument("--image-shape", type=int, nargs=2, default=None, help="override data.image_shape")
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--resume", default=None, help="a train-state file written by this script")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--val-interval", type=int, default=None,
                    help="validate every N steps (default: training.validation_interval; 0 disables)")
    ap.add_argument("--val-iters", type=int, default=25, help="at most this many batches a validation")
    return ap.parse_args(argv)


def log_artifacts(trainer, logger, dataset, batch_size: int, step: int) -> str | None:
    """The EMA model's prediction on the first (at most 4) images of a Dummy
    validation batch, gridded with their rgb and GT, through the logger."""
    import torch

    from unidepth_tpu_torch.datasets.loader import eval_batches
    from unidepth_tpu_torch.training.ema import ema_weights
    from unidepth_tpu_torch.utils.misc import normalize_rgb
    from unidepth_tpu_torch.utils.visualization import log_train_artifacts

    batch = next(iter(eval_batches(dataset, batch_size)))
    n = min(4, batch["image"].shape[0])
    device = next(trainer.model.parameters()).device
    image, rays = (torch.as_tensor(batch[k][:n]).to(device) for k in ("image", "rays"))
    with ema_weights(trainer.model, trainer.state.ema), torch.inference_mode():
        depth = trainer.model.encode_decode(normalize_rgb(image.float()), rays_gt=rays)["depth"]
    grid = log_train_artifacts([batch["image"][i] for i in range(n)], [batch["depth"][i] for i in range(n)],
                               [depth[i] for i in range(n)])
    return logger.log_image("Dummy_training", grid, step)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from unidepth_tpu_torch.datasets.dummy import Dummy
    from unidepth_tpu_torch.datasets.loader import eval_batches, make_batch
    from unidepth_tpu_torch.io.checkpoint import load_train_state, save_train_state
    from unidepth_tpu_torch.training.trainer import build_trainer, train_image_shape
    from unidepth_tpu_torch.utils.logging import MetricLogger

    if not args.dummy_data:
        raise SystemExit("scripts_torch/train.py: only --dummy-data is ported; real datasets wait for ROADMAP A8")
    config = json.loads(Path(args.config_file).read_text())
    tr = config["training"]
    if args.device is None and not torch.cuda.is_available():
        raise SystemExit("scripts_torch/train.py: no CUDA device; pass --device cpu to train on the CPU")
    image_shape = train_image_shape(config, args.image_shape)
    trainer = build_trainer(config, device=args.device, seed=args.seed, image_shape=args.image_shape)
    device = next(trainer.model.parameters()).device
    if args.resume:
        trainer.state = load_train_state(args.resume, trainer.state)
        print(f"resumed from {args.resume} at step {trainer.state.step}", flush=True)
    batch_size, accum = tr.get("batch_size", 8), tr.get("nsteps_accumulation_gradient", 1)
    family = f"{type(trainer.model).__name__} ({config['model']['pixel_encoder']['name']})"
    print(f"training {family} on {device} ({next(trainer.model.parameters()).dtype} compute, fp32 masters), "
          f"{batch_size} x {accum} images a step at {image_shape[0]}x{image_shape[1]}; "
          "no sharding (ROADMAP A8)", flush=True)
    logger = MetricLogger(run_name=Path(args.config_file).stem, out_dir=args.checkpoint_dir)
    dataset = Dummy(image_shape=image_shape, length=1024)
    val_dataset = Dummy(image_shape=image_shape, length=2 * batch_size)
    val_every = tr.get("validation_interval", 0) if args.val_interval is None else args.val_interval
    n_iters = args.steps or tr.get("n_iters", 300000)
    every = tr.get("checkpoint_interval", 10000)
    saved = None
    while trainer.state.step < n_iters:
        step = trainer.state.step
        # the batch and the draws of step n depend on (seed, n) alone, so a resumed run repeats them
        batch = make_batch(dataset, batch_size, accum, np.random.default_rng([args.seed, step]),
                           config["data"].get("num_copies", 1))
        lr = trainer.optimizer.hyperparams(trainer.state.opt_state.count)["lr"]
        t0 = time.perf_counter()
        metrics = trainer.step(batch, (args.seed, step))
        values = {k: float(v) for k, v in metrics.items()}
        line = {"step": step + 1, **values, "lr": lr, "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        logger.log({**values, "lr": lr}, step + 1)
        if not all(np.isfinite(list(values.values()))):
            raise SystemExit(f"scripts_torch/train.py: non-finite metrics at step {step + 1}")
        validating = bool(val_every) and trainer.state.step % val_every == 0
        if validating or trainer.state.step == n_iters:
            log_artifacts(trainer, logger, val_dataset, batch_size, trainer.state.step)
        if validating:
            results = trainer.validate({"Dummy": eval_batches(val_dataset, batch_size)}, max_iters=args.val_iters)
            for name, val in results.items():
                logger.log({f"{name}/{k}": v for k, v in val.items()}, trainer.state.step, prefix="val")
            print(json.dumps({"step": trainer.state.step, "val": results}), flush=True)
        if trainer.state.step % every == 0 or trainer.state.step == n_iters:
            trainer.sync_model()
            saved = save_train_state(args.checkpoint_dir, trainer.state)
            logger.log(logger.memory_stats(), trainer.state.step, prefix="sys")
            print(f"saved {saved}", flush=True)
    if device.type == "cuda":
        print(f"peak device memory {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB", flush=True)
    logger.close()
    print("done", flush=True)
    return saved


if __name__ == "__main__":
    main()
