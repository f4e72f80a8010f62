"""Small helpers (counterpart of unidepth_tpu/utils/misc.py)."""

from __future__ import annotations

import torch

from unidepth_tpu_torch.utils.constants import IMAGENET_DATASET_MEAN, IMAGENET_DATASET_STD

__all__ = ["normalize_rgb"]


def normalize_rgb(x: torch.Tensor, mode: str | None = "imagenet") -> torch.Tensor:
    """ImageNet-normalise raw (..., 3) RGB in 0..255, on ``x``'s device. The
    loader ships raw 0..255 floats and the train step normalises on the
    device, as the JAX step does; ``mode`` None, 'none' or 'identity'
    returns ``x``."""
    if mode in (None, "none", "identity"):
        return x
    mean = torch.tensor(IMAGENET_DATASET_MEAN, dtype=torch.float32, device=x.device) * 255.0
    std = torch.tensor(IMAGENET_DATASET_STD, dtype=torch.float32, device=x.device) * 255.0
    return (x - mean) / std
