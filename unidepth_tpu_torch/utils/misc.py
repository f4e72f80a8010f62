"""Small helpers (counterpart of unidepth_tpu/utils/misc.py, channel-last):
ImageNet normalisation, the encoder's stacking functions, the pad-aware
eval helpers (``remove_padding``, ``match_gt``, ``match_intrinsics``,
``ssi_helper``)."""

from __future__ import annotations

import torch

from unidepth_tpu_torch.ops.resize import resize
from unidepth_tpu_torch.utils.constants import IMAGENET_DATASET_MEAN, IMAGENET_DATASET_STD

__all__ = [
    "normalize_rgb",
    "max_stack",
    "mean_stack",
    "first_stack",
    "last_stack",
    "softmax_stack",
    "sum_stack",
    "STACKING_FNS",
    "match_gt",
    "match_intrinsics",
    "remove_padding",
    "ssi_helper",
]


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


def max_stack(tensors):
    if len(tensors) == 1:
        return tensors[0]
    return torch.stack(tensors, dim=-1).amax(dim=-1)


def mean_stack(tensors):
    if len(tensors) == 1:
        return tensors[0]
    return torch.stack(tensors, dim=-1).mean(dim=-1)


def sum_stack(tensors):
    if len(tensors) == 1:
        return tensors[0]
    return torch.stack(tensors, dim=-1).sum(dim=-1)


def first_stack(tensors):
    return tensors[0]


def last_stack(tensors):
    return tensors[-1]


def softmax_stack(tensors, temperature: float = 1.0):
    """The elements weighted by their softmax over the list."""
    if len(tensors) == 1:
        return tensors[0]
    s = torch.stack(tensors, dim=-1)
    return (torch.softmax(s / temperature, dim=-1) * s).sum(dim=-1)


STACKING_FNS = {
    "max": max_stack,
    "mean": mean_stack,
    "first": first_stack,
    "last": last_stack,
    "softmax": softmax_stack,
}


def remove_padding(x: torch.Tensor, padding: tuple[int, int, int, int]) -> torch.Tensor:
    """x (B, H, W, C) without its (l, r, t, b) pads."""
    l, r, t, b = padding
    h, w = x.shape[1:3]
    return x[:, t : h - b, l : w - r]


def match_gt(pred: torch.Tensor, gt_shape, padding1=(0, 0, 0, 0), mode: str = "bilinear") -> torch.Tensor:
    """Un-pad ``pred`` (B, H, W, C) and resize it to the GT grid
    (``align_corners=False``)."""
    return resize(remove_padding(pred, padding1), gt_shape, mode=mode, align_corners=False)


def match_intrinsics(K: torch.Tensor, src_shape, tgt_shape, padding1=(0, 0, 0, 0)) -> torch.Tensor:
    """K (B, 3, 3) rescaled for un-padding ``src_shape`` and resizing to
    ``tgt_shape``; ``K`` is not modified."""
    l, r, t, b = padding1
    h1, w1 = src_shape[0] - t - b, src_shape[1] - l - r
    h2, w2 = tgt_shape
    sx, sy = w2 / w1, h2 / h1
    K = K.clone()
    K[:, 0, 0] *= sx
    K[:, 1, 1] *= sy
    K[:, 0, 2] = (K[:, 0, 2] - l) * sx
    K[:, 1, 2] = (K[:, 1, 2] - t) * sy
    return K


def ssi_helper(x: torch.Tensor, target: torch.Tensor):
    """Closed-form scale and shift aligning ``x`` to ``target``
    (``training.losses.ssi_helper``)."""
    from unidepth_tpu_torch.training.losses import ssi_helper as _ssi

    return _ssi(x, target)
