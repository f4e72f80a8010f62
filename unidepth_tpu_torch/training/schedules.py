"""Warmup + cosine schedules (counterpart of
unidepth_tpu/training/schedules.py): each a function of the optimizer step
that returns a float32 scalar tensor, computed in float32 as the JAX
schedules are inside the optimizer.
"""

from __future__ import annotations

import math

import torch

__all__ = ["cosine_warmup", "betas_schedule"]


def cosine_warmup(base_value: float, final_value: float, warmup_iters: int, total_iters: int,
                  init_value: float | None = None):
    """Linear ``init -> base`` over ``warmup_iters``, then a half cosine
    ``base -> final`` over the rest; held at ``final`` past ``total_iters``."""
    if init_value is None:
        init_value = base_value
    main_len = max(total_iters - warmup_iters, 1)

    def schedule(step) -> torch.Tensor:
        step = torch.as_tensor(min(int(step), total_iters), dtype=torch.float32)
        if step < warmup_iters:
            return init_value + (base_value - init_value) * (step / max(warmup_iters - 1, 1))
        t = torch.clamp((step - warmup_iters) / main_len, 0.0, 1.0)
        return final_value + 0.5 * (base_value - final_value) * (1.0 + torch.cos(math.pi * t))

    return schedule


def betas_schedule(cycle: bool, warmup_iters: int, total_iters: int):
    """beta1 cycling 0.95 -> 0.85 -> 0.95 when ``cycle``, else 0.9."""
    if not cycle:
        return lambda step: torch.tensor(0.9, dtype=torch.float32)
    return cosine_warmup(0.85, 0.95, warmup_iters, total_iters, init_value=0.95)
