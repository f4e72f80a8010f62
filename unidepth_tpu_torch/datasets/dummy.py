"""Synthetic dataset (a copy of unidepth_tpu/datasets/dummy.py, which the
port may not import): uniform random depth and uint8 image, one pinhole
camera, every pixel valid."""

from __future__ import annotations

import numpy as np


class Dummy:
    min_depth = 0.1
    max_depth = 10.0

    def __init__(self, image_shape=(64, 80), length=64, seed=0, **kwargs):
        self.image_shape = tuple(image_shape)
        self.length = length
        self.seed = seed

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        h, w = self.image_shape
        rng = np.random.default_rng(self.seed + idx)
        depth = rng.uniform(self.min_depth, self.max_depth, (h, w)).astype(np.float32)
        K = np.asarray([[0.7 * w, 0, w / 2], [0, 0.7 * w, h / 2], [0, 0, 1]], np.float32)
        return {
            "image": rng.integers(0, 255, (h, w, 3), dtype=np.uint8),
            "depth": depth,
            "depth_mask": depth > 0,
            "K": K,
            "validity": np.ones((h, w), bool),
            "flip": False,
            "si": False,
            "dataset": "Dummy",
        }
