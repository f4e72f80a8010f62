#!/usr/bin/env python3
"""Train UniDepthV2 with the PyTorch port on one device.

    python3 scripts_torch/train.py --config-file configs/config_v2_vitl14.json --dummy-data --steps N \\
        [--seed 13] [--image-shape H W] [--checkpoint-dir checkpoints] [--resume PATH] [--device cpu]

The counterpart of scripts/train.py for one process and one device: the
card unless ``--device`` names another (without a card and without
``--device cpu`` it raises). Random weights (``init_params(seed)``), the
config's training section (losses, AdamW with its schedules, clipping, EMA,
``batch_size`` x ``nsteps_accumulation_gradient``), the image shape floored
to multiples of 14. Data: ``--dummy-data`` only; the real datasets wait for
ROADMAP A8. It does not validate (ROADMAP A6) and does not shard (A8).

Prints one JSON line a step (step, the loss slots, grad_norm, lr, seconds)
and, on the card, the peak device memory. Saves the whole train state to
``--checkpoint-dir`` every ``training.checkpoint_interval`` steps and at the
end; ``--resume`` continues from such a file, bit for bit on the CPU.
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
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from unidepth_tpu_torch.datasets.dummy import Dummy
    from unidepth_tpu_torch.datasets.loader import make_batch
    from unidepth_tpu_torch.io.checkpoint import load_train_state, save_train_state
    from unidepth_tpu_torch.training.trainer import build_trainer, train_image_shape

    if not args.dummy_data:
        raise SystemExit("scripts_torch/train.py: only --dummy-data is ported; real datasets wait for ROADMAP A8")
    config = json.loads(Path(args.config_file).read_text())
    tr = config["training"]
    if args.device is None and not torch.cuda.is_available():
        raise SystemExit("scripts_torch/train.py: no CUDA device; pass --device cpu to train on the CPU")
    image_shape = train_image_shape(config, args.image_shape)
    trainer = build_trainer(config, device=args.device, seed=args.seed)
    device = next(trainer.model.parameters()).device
    if args.resume:
        trainer.state = load_train_state(args.resume, trainer.state)
        print(f"resumed from {args.resume} at step {trainer.state.step}", flush=True)
    batch_size, accum = tr.get("batch_size", 8), tr.get("nsteps_accumulation_gradient", 1)
    print(f"training UniDepthV2 on {device} ({next(trainer.model.parameters()).dtype} compute, fp32 masters), "
          f"{batch_size} x {accum} images a step at {image_shape[0]}x{image_shape[1]}; "
          "no validation (ROADMAP A6), no sharding (ROADMAP A8)", flush=True)
    dataset = Dummy(image_shape=image_shape, length=1024)
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
        if not all(np.isfinite(list(values.values()))):
            raise SystemExit(f"scripts_torch/train.py: non-finite metrics at step {step + 1}")
        if trainer.state.step % every == 0 or trainer.state.step == n_iters:
            trainer.sync_model()
            saved = save_train_state(args.checkpoint_dir, trainer.state)
            print(f"saved {saved}", flush=True)
    if device.type == "cuda":
        print(f"peak device memory {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB", flush=True)
    print("done", flush=True)
    return saved


if __name__ == "__main__":
    main()
