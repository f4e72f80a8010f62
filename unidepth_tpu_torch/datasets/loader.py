"""Batch assembly (counterpart of part of unidepth_tpu/datasets/loader.py):
``collate`` stacks equal-shape samples into channel-last numpy arrays, with
rays from the port's ``Pinhole``; ``make_batch`` draws the samples of one
optimizer step as ``Loader._make_batch`` does for one dataset (an index,
``num_copies`` interleaved copies a draw) and stacks the micro-batches
along a leading accumulation axis. Only pinhole cameras and one
fixed-shape dataset are ported; the threaded loader, weighted dataset
mixing, shape sampling and the real datasets wait for ROADMAP A8.
"""

from __future__ import annotations

import numpy as np
import torch

from unidepth_tpu_torch.geometry.cameras import Pinhole

__all__ = ["collate", "make_batch"]


def collate(samples: list[dict]) -> dict:
    """Stack equal-shape samples into a channel-last numpy batch; images stay
    raw 0..255 floats (the train step normalises on the device)."""
    imgs = np.stack([s["image"] for s in samples]).astype(np.float32)
    h, w = imgs.shape[1:3]
    depth = np.stack([s["depth"] for s in samples])[..., None].astype(np.float32)
    mask = np.stack([s.get("depth_mask", s["depth"] > 0) for s in samples])[..., None]
    validity = np.stack([s.get("validity", np.ones((h, w), bool)) for s in samples])[..., None].astype(np.float32)
    K = np.stack([s["K"] for s in samples]).astype(np.float32)
    models = {s.get("camera_model", "Pinhole") for s in samples}
    if models != {"Pinhole"}:
        raise NotImplementedError(f"camera models {sorted(models)}: only Pinhole is ported (ROADMAP A4)")
    rays = Pinhole.from_K(torch.from_numpy(K)).get_rays(h, w).reshape(len(samples), h * w, 3).numpy()
    return {
        "image": imgs,
        "depth": depth,
        "depth_mask": mask,
        "validity_mask": validity,
        "K": K,
        "rays": rays,
        "si": np.asarray([float(s.get("si", False)) for s in samples], np.float32),
        "ssi": np.asarray([float(s.get("ssi", False)) for s in samples], np.float32),
        "dense": np.asarray([float(s.get("dense", False)) for s in samples], np.float32),
        "quality": np.asarray([int(s.get("quality", 0)) for s in samples], np.int32),
        "flips": np.asarray([bool(s.get("flip", False)) for s in samples]),
    }


def make_batch(dataset, batch_size: int, accum: int, rng: np.random.Generator, num_copies: int = 1) -> dict:
    """One optimizer step's batch from ``dataset`` (indexable, one shape):
    leaves (accum, batch_size, ...), or (batch_size, ...) when ``accum`` is
    1; each index drawn from ``rng`` and taken ``num_copies`` times in a
    row."""
    if batch_size % num_copies:
        raise ValueError(f"batch_size {batch_size} not divisible by num_copies {num_copies}")
    micro = []
    for _ in range(accum):
        samples = []
        for _ in range(batch_size // num_copies):
            idx = int(rng.integers(0, len(dataset)))
            samples.extend(dataset[idx] for _ in range(num_copies))
        micro.append(collate(samples))
    if accum == 1:
        return micro[0]
    return {k: np.stack([m[k] for m in micro]) for k in micro[0]}
