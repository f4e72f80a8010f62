"""Checkpoint loading from local files (counterpart of unidepth_tpu/io/hub.py,
local paths only: neither the checkpoints nor a network are assumed).

``name_or_path`` is a directory holding ``model.safetensors``,
``pytorch_model.bin`` or ``model.bin`` (and usually ``config.json``), or a
checkpoint file itself (a ``config.json`` beside it is read). An explicit
``config`` overrides any ``config.json``; with neither, the config comes
from the repo's ``configs/`` by the backbone named in the path
(``_default_config``). The JAX loader's other two sources are not taken: a
Hub repo id (a download) and the orbax ``params/`` tree of
``scripts/convert.py`` (it needs JAX).

The state_dict gets the reference loader's remaps before a model selects
its keys (``io.convert.normalize_state_dict``): the ``{"model": ...}``
wrapper and every ``module.`` are removed, DINOv2's chunked
``blocks.{chunk}.{i}`` layout is flattened, and the FB and CLIP ConvNeXt
layouts become the timm one. ``safetensors`` is imported only for a
``.safetensors`` file.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from unidepth_tpu_torch.io.convert import normalize_state_dict

__all__ = ["load_checkpoint"]

WEIGHT_FILES = ("model.safetensors", "pytorch_model.bin", "model.bin")
CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs"
# the JAX loader's table: a backbone named in the path -> the V2 config
# whose ``v2`` the version replaces
_BACKBONE_TO_CONFIG = {
    "vits": "config_v2_vits14.json",
    "vitb": "config_v2_vitb14.json",
    "vitl": "config_v2_vitl14.json",
}


def _read_state_dict(path: Path) -> dict[str, torch.Tensor]:
    if path.suffix == ".safetensors":
        from safetensors.torch import load_file

        return load_file(str(path))
    return torch.load(str(path), map_location="cpu", weights_only=True)


def _default_config(version: str, backbone: str) -> dict:
    """The shipped config of ``version`` ('1', '2' or '2old') for the first
    backbone of ``_BACKBONE_TO_CONFIG`` named in ``backbone``."""
    for key, fname in _BACKBONE_TO_CONFIG.items():
        if key in backbone:
            path = CONFIG_DIR / fname.replace("v2", f"v{version}")
            if path.is_file():
                return json.loads(path.read_text())
    raise FileNotFoundError(f"no config for version={version} backbone={backbone}")


def load_checkpoint(name_or_path, version: str = "2", config: dict | None = None):
    """(config, state_dict) for a local checkpoint directory or file;
    ``version`` picks the default config when neither ``config`` nor a
    ``config.json`` is found."""
    path = Path(name_or_path)
    cfg_path = None
    if path.is_dir():
        cfg_path = path / "config.json"
        weights = next((path / f for f in WEIGHT_FILES if (path / f).is_file()), None)
        if weights is None:
            orbax = " (an orbax params/ tree needs the JAX package)" if (path / "params").is_dir() else ""
            raise FileNotFoundError(f"no {' / '.join(WEIGHT_FILES)} under {path}{orbax}")
    elif path.is_file():
        cfg_path, weights = path.parent / "config.json", path
    else:
        raise FileNotFoundError(f"{name_or_path}: no such checkpoint file or directory (a Hub download is not ported)")
    if config is None and cfg_path.is_file():
        config = json.loads(cfg_path.read_text())
    if config is None:
        config = _default_config(version, str(name_or_path))
    return config, normalize_state_dict(_read_state_dict(weights), config)
