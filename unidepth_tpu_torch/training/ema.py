"""Exponential moving average of the parameters (counterpart of
unidepth_tpu/training/ema.py): the reference's tanh decay ramp with a
delayed start, and its interval cadence. The shadow is updated in place.
``ema_weights`` puts the shadow into a model for the length of a block (the
reference's ``ema_handle.average_parameters()``).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

__all__ = ["EMAState", "ema_decay", "ema_init", "ema_update", "ema_weights"]


@dataclasses.dataclass
class EMAState:
    shadow: dict[str, torch.Tensor]
    num_updates: int


def ema_init(params: dict) -> EMAState:
    """A copy of the parameters: the shadow never aliases them."""
    return EMAState(shadow={n: p.detach().clone() for n, p in params.items()}, num_updates=0)


def ema_decay(n: int, decay: float, update_after_step: int, tau: int, every: int) -> float:
    """The shadow's decay at update ``n`` (1-based), in float32: 1.0 off the
    interval (the shadow stays), 0.0 before the ramp starts (the shadow
    takes the parameters), else ``tanh(epoch / tau) * decay``."""
    if n % every:
        return 1.0
    epoch = max(float(torch.tensor(n // every, dtype=torch.float32)) - update_after_step - 1, 0.0)
    if epoch <= 0:
        return 0.0
    return float(torch.tanh(torch.tensor(epoch, dtype=torch.float32) / tau) * decay)


@torch.no_grad()
def ema_update(state: EMAState, params: dict, decay: float = 0.9995, update_after_step: int = 7500,
               tau: int = 20000, every: int = 1) -> EMAState:
    """One gated step: the shadow moves only on steps divisible by
    ``every``, ``shadow - (1 - d) (shadow - params)``; ``update_after_step``
    and ``tau`` count updates, not steps (the reference's interval)."""
    state.num_updates += 1
    d = ema_decay(state.num_updates, decay, update_after_step, tau, every)
    if d != 1.0:
        names = list(state.shadow)
        shadow = [state.shadow[n] for n in names]
        diff = torch._foreach_sub(shadow, [params[n] for n in names])
        torch._foreach_mul_(diff, float(1.0 - torch.tensor(d, dtype=torch.float32)))
        torch._foreach_sub_(shadow, diff)
    return state


@contextlib.contextmanager
def ema_weights(model: torch.nn.Module, state: EMAState, layout=None):
    """Inside the block the model's parameters hold the shadow, cast to
    their dtype; after it they hold their own values again, bit for bit
    (kept as a copy). Nothing else is written: the fp32 masters stay as they
    are. ``layout`` (``parallel.mesh.Layout``): the shadow is this rank's
    shards, all-gathered into the model."""
    params = dict(model.named_parameters())
    live = {n: p.detach().clone() for n, p in params.items()}
    with torch.no_grad():
        if layout is not None:
            layout.load_into(params, state.shadow)
        else:
            for n, p in params.items():
                p.copy_(state.shadow[n])
    try:
        yield model
    finally:
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(live[n])
