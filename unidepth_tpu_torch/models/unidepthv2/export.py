"""Serialized model export (counterpart of
unidepth_tpu/models/unidepthv2/export.py).

``export_forward`` serialises the forward without pre- and postprocessing,
``(image[, rays]) -> (points, confidence, intrinsics)`` through
``encode_decode``, with ``torch.export`` into a ``.pt2`` archive: the
program and the weights, on the model's device and in its dtype. With
``with_camera`` the archive takes the ground-truth rays (B, H * W, 3) too.

The trace runs on the kernels' plain versions (``model.set_kernels(False)``,
the counterpart of the JAX exporter tracing with the XLA attention): the
hand kernels are ctypes launches that a trace cannot see, and without them
the program holds only aten operators, so ``torch.export.load`` runs it in
a process that has neither this repository nor its compiled library.

Usage:
  python -m unidepth_tpu_torch.models.unidepthv2.export --config-file \\
      configs/config_v2_vitl14.json --shape 462 616 --output unidepthv2.pt2 [--device cpu]
"""

from __future__ import annotations

import argparse
import io
import json
import threading
from pathlib import Path

import torch
import torch.nn as nn

_EXPORT_LOCK = threading.Lock()


class _Forward(nn.Module):
    """The stripped forward as a module for ``torch.export``."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, image, rays=None):
        out = self.model.encode_decode(image, rays_gt=rays)
        return out["points"], out["confidence"], out["intrinsics"]


def export_forward(model, shape: tuple[int, int], with_camera: bool = False, batch: int = 1) -> bytes:
    """The ``torch.export.save`` bytes of the stripped forward of ``model``
    (a ``UniDepthV2``) at ``batch`` float32 images of ``shape`` (H, W, both
    multiples of 14), traced on the model's device under
    ``set_kernels(False)``. Exports are serialised by a lock, and every
    module's kernel flag is restored afterwards, also when the trace
    raises: a serving call made meanwhile from another thread would
    otherwise run the plain versions."""
    h, w = shape
    p = next(model.parameters())
    image = torch.zeros(batch, h, w, 3, device=p.device)
    args = (image, torch.zeros(batch, h * w, 3, device=p.device)) if with_camera else (image,)
    with _EXPORT_LOCK:
        flags = {m: m.use_kernels for m in model.modules() if hasattr(m, "use_kernels")}
        model.set_kernels(False)
        try:
            with torch.no_grad():
                program = torch.export.export(_Forward(model).eval(), args)
        finally:
            for m, flag in flags.items():
                m.use_kernels = flag
            model._reset_serving_caches()
    buffer = io.BytesIO()
    torch.export.save(program, buffer)
    return buffer.getvalue()


def main(argv=None):
    ap = argparse.ArgumentParser(description="Export the stripped UniDepthV2 forward with torch.export.")
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--checkpoint", default=None, help="a local checkpoint (from_pretrained)")
    ap.add_argument("--shape", type=int, nargs=2, default=(462, 616))
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--with-camera", action="store_true")
    ap.add_argument("--output", default="unidepthv2.pt2")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2

    config = json.loads(Path(args.config_file).read_text())
    if args.checkpoint:
        model = UniDepthV2.from_pretrained(args.checkpoint, device=args.device)
    else:
        model = UniDepthV2.from_config(config, device=args.device).init_params(seed=0)
    h, w = args.shape
    h, w = (h // 14) * 14, (w // 14) * 14
    blob = export_forward(model.eval(), (h, w), args.with_camera, args.batch)
    Path(args.output).write_bytes(blob)
    print(f"exported ({len(blob) / 1e6:.1f} MB) -> {args.output}")


if __name__ == "__main__":
    main()
