#!/usr/bin/env python3
"""Evaluate UniDepth with the PyTorch port on one device.

    python3 scripts_torch/eval.py --config-file configs/config_v2_vitl14.json \\
        (--data-root DIR --datasets KITTI NYUv2Depth | --dummy-data) \\
        [--checkpoint DIR] [--max-iters N] [--batch 4] [--eval-3d] [--device cpu]

The counterpart of scripts/eval.py: every depth metric of
``utils.evaluation.DEPTH_METRICS`` and, with ``--eval-3d``, the Chamfer
distance and F1-AUC, a table a dataset, then one JSON line ``{"eval":
{dataset: {metric: value}}}``. It runs on the card unless ``--device``
names another (without a card and without ``--device cpu`` it raises). The
model class comes from the config's ``model.name``: UniDepthV2,
UniDepthV1 or UniDepthV2old. ``--checkpoint`` loads
a local directory (``from_pretrained``); without it the weights are random
(``init_params(seed=0)``) and the metrics say nothing of the model. Data:
each dataset of ``--datasets`` (default: ``data.val_datasets``) in test
mode through ``make_dataset``, HDF5 shards under ``--data-root`` (default:
``$DATAROOT``; h5py is needed, and PIL for JPEG images), or the Dummy
dataset (``--dummy-data``, or the name Dummy), at the config's image shape
floored to multiples of 14.
"""

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--checkpoint", default=None, help="a local checkpoint directory (from_pretrained)")
    ap.add_argument("--datasets", nargs="*", default=None, help="dataset names (default: data.val_datasets)")
    ap.add_argument("--data-root", default=os.environ.get("DATAROOT"),
                    help="the directory of the HDF5 shards (default: $DATAROOT)")
    ap.add_argument("--max-iters", type=int, default=None, help="at most this many batches a dataset")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--dummy-data", action="store_true", help="evaluate on the synthetic Dummy dataset")
    ap.add_argument("--eval-3d", action="store_true", help="also the Chamfer distance and F1-AUC of the points")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    return ap.parse_args(argv)


def build_model(config: dict, checkpoint, device):
    """The config's model family on ``device``: from ``checkpoint``, else
    with random weights."""
    name = config.get("model", {}).get("name", "UniDepthV2")
    if name == "UniDepthV1":
        from unidepth_tpu_torch.models.unidepthv1.model import UniDepthV1 as model_cls
    elif name == "UniDepthV2old":
        from unidepth_tpu_torch.models.unidepthv2.old import UniDepthV2old as model_cls
    elif name == "UniDepthV2":
        from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2 as model_cls
    else:
        raise SystemExit(f"scripts_torch/eval.py: unknown model {name}")
    if checkpoint:
        return model_cls.from_pretrained(checkpoint, device=device).eval()
    print("!! random weights (no --checkpoint): metrics are meaningless", flush=True)
    return model_cls.from_config(config, device=device).init_params(seed=0).eval()


def main(argv=None) -> dict:
    args = parse_args(argv)
    import torch

    from unidepth_tpu_torch.datasets.base import make_dataset
    from unidepth_tpu_torch.datasets.dummy import Dummy
    from unidepth_tpu_torch.datasets.loader import eval_batches
    from unidepth_tpu_torch.datasets.specs import SPECS
    from unidepth_tpu_torch.training.trainer import train_image_shape
    from unidepth_tpu_torch.utils.validation import validate

    if args.device is None and not torch.cuda.is_available():
        raise SystemExit("scripts_torch/eval.py: no CUDA device; pass --device cpu to evaluate on the CPU")
    config = json.loads(Path(args.config_file).read_text())
    names = args.datasets or config["data"].get("val_datasets") or (["Dummy"] if args.dummy_data else [])
    real = [n for n in names if n != "Dummy" and not args.dummy_data]
    if real and not args.data_root:
        raise SystemExit(f"scripts_torch/eval.py: no data root for {real}: pass --data-root DIR (or set DATAROOT), "
                         "or --dummy-data")
    if real and not Path(args.data_root).is_dir():
        raise SystemExit(f"scripts_torch/eval.py: data root {args.data_root} is not a directory")
    if not names:
        raise SystemExit("scripts_torch/eval.py: no dataset; pass --dummy-data or --datasets")
    model = build_model(config, args.checkpoint, args.device)
    image_shape = train_image_shape(config)
    p = next(model.parameters())
    print(f"evaluating {type(model).__name__} on {p.device} ({p.dtype}), {names} at {image_shape[0]}x{image_shape[1]}, "
          f"batch {args.batch}", flush=True)
    loaders = {n: eval_batches(make_dataset(n, data_root=args.data_root, test_mode=True, image_shape=image_shape)
                               if n in real else Dummy(image_shape=image_shape, length=32), args.batch) for n in names}
    ranges = {n: (SPECS[n].min_depth, SPECS[n].max_depth) for n in names if n in SPECS}
    results = validate(model, loaders, max_iters=args.max_iters, with_3d=args.eval_3d, depth_ranges=ranges)
    for name, metrics in results.items():
        print(f"\n== {name} ==")
        for k in sorted(metrics):
            print(f"  {k:>12s}: {metrics[k]:.4f}")
    print(json.dumps({"eval": results}), flush=True)
    return results


if __name__ == "__main__":
    main()
