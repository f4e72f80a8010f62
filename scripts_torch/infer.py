#!/usr/bin/env python3
"""Batch / multi-camera inference CLI of the PyTorch port (the counterpart of
scripts/infer.py).

Streams the images under ``--input`` (any depth: NuScenes-style 6-view
frames grouped by subfolder included) through ``infer()`` in batches of
images of one size; saves depth as a 16-bit PNG in millimetres, and with
``--save-panel`` an RGB | depth panel, with ``--save-ply`` a PLY point
cloud. Outputs are named by the path relative to ``--input``, its parts
joined by ``_``, so the six ``frame/CAM_*.png`` of each frame keep apart.

    python3 scripts_torch/infer.py --input imgs/ --output out/ \\
        [--checkpoint DIR] [--version 2] [--config CFG] [--intrinsics K.npy] \\
        [--resolution-level 9] [--batch 8] [--save-ply] [--save-panel] [--device cpu]

The model runs on the card unless ``--device`` names another device
(without a card and without ``--device cpu`` it raises). Without
``--checkpoint`` the weights are random (``init_params(seed=0)``) in the
model of ``--config``, by default the family's shipped ViT-L/14 config.
PNG is read and written by ``utils.png``; JPEG is decoded by PIL, imported
at the call.
"""

import argparse
import json
import struct
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SUFFIXES = (".png", ".jpg", ".jpeg")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--checkpoint", default=None, help="a local checkpoint directory (from_pretrained)")
    ap.add_argument("--version", type=int, default=2, choices=(1, 2))
    ap.add_argument("--config", default=None, help="config JSON for random weights")
    ap.add_argument("--intrinsics", default=None, help="a (3, 3) K in a .npy file, for every image")
    ap.add_argument("--resolution-level", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--save-ply", action="store_true")
    ap.add_argument("--save-panel", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    return ap.parse_args(argv)


def image_size(path: Path) -> tuple[int, int]:
    """(width, height) of an image, from a PNG's header or PIL's."""
    with open(path, "rb") as f:
        head = f.read(24)
    from unidepth_tpu_torch.utils.png import is_png

    if is_png(head):
        return struct.unpack(">II", head[16:24])
    from PIL import Image

    with Image.open(path) as im:
        return im.size


def output_stem(path: Path, root: Path) -> str:
    """The path relative to ``root``, without its suffix, parts joined by _."""
    return "_".join(path.relative_to(root).with_suffix("").parts)


def main(argv=None) -> float:
    """Run the CLI; returns the images/s of the whole run."""
    args = parse_args(argv)
    import torch

    from unidepth_tpu_torch.datasets.base import decode_rgb
    from unidepth_tpu_torch.models.unidepthv1.model import UniDepthV1
    from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2
    from unidepth_tpu_torch.utils.png import write_png
    from unidepth_tpu_torch.utils.visualization import colorize, image_grid, save_point_cloud

    if args.device is None and not torch.cuda.is_available():
        raise SystemExit("scripts_torch/infer.py: no CUDA device; pass --device cpu to run on the CPU")
    cls = UniDepthV2 if args.version == 2 else UniDepthV1
    if args.checkpoint:
        model = cls.from_pretrained(args.checkpoint, device=args.device)
    else:
        name = args.config or ROOT / "configs" / f"config_v{args.version}_vitl14.json"
        model = cls.from_config(json.loads(Path(name).read_text()), device=args.device).init_params(seed=0)
        print("!! random weights (no --checkpoint)")
    model.eval()
    if args.resolution_level is not None:
        if args.version == 1:
            # V1 runs at its fixed network shape
            print("WARNING: --resolution-level has no effect on UniDepthV1")
        model.resolution_level = args.resolution_level

    K = np.load(args.intrinsics) if args.intrinsics else None
    root, out_dir = Path(args.input), Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = sorted(p for p in root.rglob("*") if p.suffix.lower() in SUFFIXES)
    # equal-size images batch together
    by_size: dict[tuple, list] = {}
    for p in paths:
        by_size.setdefault(image_size(p), []).append(p)

    n_done, rate = 0, 0.0
    t0 = time.time()
    for group in by_size.values():
        for i in range(0, len(group), args.batch):
            chunk = group[i : i + args.batch]
            imgs = np.stack([decode_rgb(p.read_bytes()) for p in chunk])
            out = model.infer(imgs, camera=K) if args.version == 2 else model.infer(imgs, intrinsics=K)
            depth = out["depth"][..., 0].float().cpu().numpy()
            points = out["points"].float().cpu().numpy() if args.save_ply else None
            for j, p in enumerate(chunk):
                stem = output_stem(p, root)
                write_png(out_dir / f"{stem}_depth.png", np.clip(depth[j] * 1000.0, 0, 65535).astype(np.uint16))
                if args.save_panel:
                    write_png(out_dir / f"{stem}_panel.png", image_grid([imgs[j], colorize(depth[j])], 1, 2))
                if args.save_ply:
                    save_point_cloud(out_dir / f"{stem}.ply", points[j].reshape(-1, 3), imgs[j].reshape(-1, 3))
            n_done += len(chunk)
            rate = n_done / (time.time() - t0)
            print(f"{n_done}/{len(paths)} images ({rate:.2f} img/s)", flush=True)
    return rate


if __name__ == "__main__":
    main()
