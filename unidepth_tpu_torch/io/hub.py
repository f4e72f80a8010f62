"""Checkpoint loading from a local directory (counterpart of
unidepth_tpu/io/hub.py, local paths only: neither the checkpoints nor a
network are assumed).

A checkpoint directory holds ``config.json`` and ``model.safetensors`` or
``pytorch_model.bin`` with the reference state_dict keys; a DDP ``module.``
prefix and a ``{"model": ...}`` wrapper are removed, as the reference's
loader does. ``safetensors`` is imported only for a ``.safetensors`` file.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

__all__ = ["load_checkpoint"]

WEIGHT_FILES = ("model.safetensors", "pytorch_model.bin", "model.bin")


def _read_state_dict(path: Path) -> dict[str, torch.Tensor]:
    if path.suffix == ".safetensors":
        from safetensors.torch import load_file

        return load_file(str(path))
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    return sd


def load_checkpoint(local_dir) -> tuple[dict, dict[str, torch.Tensor]]:
    """(config, state_dict) from ``local_dir``."""
    root = Path(local_dir)
    cfg_path = root / "config.json"
    if not cfg_path.is_file():
        raise FileNotFoundError(f"no config.json under {root}")
    weights = next((root / f for f in WEIGHT_FILES if (root / f).is_file()), None)
    if weights is None:
        raise FileNotFoundError(f"no {' / '.join(WEIGHT_FILES)} under {root}")
    sd = _read_state_dict(weights)
    sd = {k.replace("module.", ""): v for k, v in sd.items()}
    return json.loads(cfg_path.read_text()), sd
