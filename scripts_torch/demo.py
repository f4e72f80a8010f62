#!/usr/bin/env python3
"""The golden-path demo of the PyTorch port: infer on the demo image and
report ARel against its ground-truth depth.

    python3 scripts_torch/demo.py [--checkpoint DIR] [--version 2] [--config CFG] \\
        [--rgb assets/demo/rgb.png --depth assets/demo/depth.png --intrinsics assets/demo/intrinsics.npy] \\
        [--output assets/demo/output.png] [--device cpu]

The counterpart of scripts/demo.py: ``infer(rgb, camera=K)`` (V2) or
``infer(rgb, intrinsics=K)`` (``--version 1``) on the card unless
``--device`` names another (without a card and without ``--device cpu`` it
raises), then ``ARel: x%`` over the pixels with depth, and an RGB / depth /
confidence panel written to ``--output``. The depth PNG is 16-bit grey in
millimetres. The released UniDepthV2 ViT-L/14 weights give ~7.45% ARel on
these assets; without ``--checkpoint`` the weights are random
(``init_params(seed=0)``) and the figure says nothing of the model. The PNGs
are read and written by ``utils.png``.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", default=None, help="a local checkpoint directory (from_pretrained)")
    ap.add_argument("--version", type=int, default=2, choices=(1, 2))
    ap.add_argument("--config", default=None, help="config JSON for random weights")
    ap.add_argument("--rgb", default="assets/demo/rgb.png")
    ap.add_argument("--depth", default="assets/demo/depth.png")
    ap.add_argument("--intrinsics", default="assets/demo/intrinsics.npy")
    ap.add_argument("--output", default="assets/demo/output.png")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv=None) -> float | None:
    args = parse_args(argv)
    import torch

    from unidepth_tpu_torch.models.unidepthv1.model import UniDepthV1
    from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2
    from unidepth_tpu_torch.utils.png import read_png, write_png
    from unidepth_tpu_torch.utils.visualization import colorize, image_grid

    if args.device is None and not torch.cuda.is_available():
        raise SystemExit("scripts_torch/demo.py: no CUDA device; pass --device cpu to run on the CPU")
    cls = UniDepthV2 if args.version == 2 else UniDepthV1
    if args.checkpoint:
        model = cls.from_pretrained(args.checkpoint, device=args.device)
    else:
        print("!! no checkpoint: random weights, ARel will be meaningless !!", flush=True)
        name = args.config or f"configs/config_v{args.version}_vitl14.json"
        model = cls.from_config(json.loads(Path(name).read_text()), device=args.device).init_params(seed=0)
    model.eval()

    if Path(args.rgb).exists():
        rgb = read_png(args.rgb)
    else:
        print(f"{args.rgb} missing; using a synthetic image", flush=True)
        rgb = np.random.default_rng(0).integers(0, 255, (480, 640, 3), dtype=np.uint8)
    K = np.load(args.intrinsics) if Path(args.intrinsics).exists() else None
    out = model.infer(rgb, camera=K) if args.version == 2 else model.infer(rgb, intrinsics=K)
    depth_pred = out["depth"][0, ..., 0].float().cpu().numpy()

    arel = None
    if not Path(args.depth).exists():
        print("no GT depth; skipping ARel")
    else:
        gt = read_png(args.depth).astype(np.float64) / 1000.0
        if gt.shape != depth_pred.shape:
            print(f"GT depth {gt.shape} does not match prediction {depth_pred.shape}; skipping ARel")
        else:
            valid = gt > 0
            arel = float(np.mean(np.abs(gt[valid] - depth_pred[valid]) / gt[valid]))
            print(f"ARel: {arel * 100:.2f}%", flush=True)

    conf = out["confidence"][0, ..., 0].float().cpu().numpy() if "confidence" in out else depth_pred
    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    write_png(args.output, image_grid([rgb, colorize(depth_pred), colorize(conf)], 1, 3))
    print(f"saved {args.output}; predicted K:\n{out['intrinsics'][0].float().cpu().numpy()}")
    return arel


if __name__ == "__main__":
    main()
