"""The work of one image, counted by running a configuration's reference on
the ``meta`` device (``reference/ops.py`` ``Tally``): the algorithm's
products at the cell's shapes, whatever the program runs them on."""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.ops import Numerics, Tally


def per_image(family, config: dict, param_shapes: dict, image_hw) -> dict:
    """The reference's work for one (H, W) uint8 image, as a dict of
    ``Tally``'s fields."""
    weights = {k: torch.empty(shape, device="meta") for k, shape in param_shapes.items()}
    tally = Tally()
    family.infer_reference(Numerics(tally=tally), weights, config, torch.empty(1, *image_hw, 3, device="meta"))
    return dataclasses.asdict(tally)
