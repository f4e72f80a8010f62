"""Train-state checkpoints (counterpart of unidepth_tpu/io/checkpoint.py,
which uses orbax): the whole ``TrainState`` (float32 parameters, Adam
moments and count, EMA shadow and its count, step) in one ``torch.save``
file, ``step_XXXXXXXX.pt`` in the checkpoint directory. ``load_train_state``
restores into a state built for the same model, on that state's devices, so
a resumed run continues bit for bit where the saved one stopped.
"""

from __future__ import annotations

from pathlib import Path

import torch

from unidepth_tpu_torch.training.ema import EMAState
from unidepth_tpu_torch.training.optim import AdamWState
from unidepth_tpu_torch.training.step import TrainState

__all__ = ["load_train_state", "save_train_state"]


def save_train_state(directory, state: TrainState) -> Path:
    path = Path(directory) / f"step_{state.step:08d}.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(
        {
            "params": state.params,
            "opt": {"count": state.opt_state.count, "mu": state.opt_state.mu, "nu": state.opt_state.nu},
            "ema": {"shadow": state.ema.shadow, "num_updates": state.ema.num_updates},
            "step": state.step,
        },
        path,
    )
    return path


def load_train_state(path, template: TrainState) -> TrainState:
    """The state saved at ``path``, each tensor placed like the template's;
    raises if the names or shapes differ."""
    saved = torch.load(path, map_location="cpu", weights_only=True)

    def place(tensors: dict, like: dict) -> dict:
        if list(tensors) != list(like):
            raise ValueError(f"{path}: parameter names differ from the model's")
        for name, t in tensors.items():
            if t.shape != like[name].shape:
                raise ValueError(f"{path}: {name} has shape {tuple(t.shape)}, the model {tuple(like[name].shape)}")
        return {n: t.to(like[n].device, like[n].dtype) for n, t in tensors.items()}

    return TrainState(
        params=place(saved["params"], template.params),
        opt_state=AdamWState(count=int(saved["opt"]["count"]), mu=place(saved["opt"]["mu"], template.opt_state.mu),
                             nu=place(saved["opt"]["nu"], template.opt_state.nu)),
        ema=EMAState(shadow=place(saved["ema"]["shadow"], template.ema.shadow),
                     num_updates=int(saved["ema"]["num_updates"])),
        step=int(saved["step"]),
    )
