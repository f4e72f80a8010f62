"""The trainer of UniDepthV1 (ViT or ConvNeXt), UniDepthV2 and UniDepthV2old
(what ``scripts_torch/train.py`` runs): the model from a config with random
weights, float32 masters beside its compute-dtype copy, the optimizer and
schedules of the config's training section, the family's train step (V1's
loss slots for V1, V2's for V2 and V2old, as the JAX trainer does), and
validation under the EMA shadow. On one device, or on one rank of a
``parallel.mesh.Mesh``: the model split over its tp axis
(``parallel.tp.shard_model_``), the masters, moments and shadow over its
fsdp axis (``layout``), and validation's metrics gathered over its batch
axes.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
import torch.nn as nn

from unidepth_tpu_torch.models.backbones.convnext import ConvNeXt
from unidepth_tpu_torch.models.unidepthv1.model import UniDepthV1
from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2, compute_dtype, resolve_device
from unidepth_tpu_torch.models.unidepthv2.old import UniDepthV2old
from unidepth_tpu_torch.parallel.mesh import Layout, Mesh
from unidepth_tpu_torch.parallel.tp import shard_model_
from unidepth_tpu_torch.training.ema import ema_weights
from unidepth_tpu_torch.training.optim import AdamW, build_optimizer
from unidepth_tpu_torch.training.step import TrainState, make_train_step, make_train_step_v1, master_params, sync_model
from unidepth_tpu_torch.utils.validation import validate

__all__ = ["MODELS", "Trainer", "build_trainer", "num_encoder_layers", "train_image_shape"]

MODELS = {"UniDepthV1": UniDepthV1, "UniDepthV2": UniDepthV2, "UniDepthV2old": UniDepthV2old}


@dataclasses.dataclass
class Trainer:
    model: nn.Module  # a model of MODELS
    optimizer: AdamW
    state: TrainState
    train_step: object  # (state, batch, seed) -> (state, metrics)
    layout: Layout | None = None  # the mesh and each parameter's split; None: one process

    def step(self, batch: dict, seed) -> dict:
        self.state, metrics = self.train_step(self.state, batch, seed)
        return metrics

    def sync_model(self) -> None:
        """Write the float32 masters into the model (its parameters and the
        int8 path's masters)."""
        sync_model(self.model, self.state, self.layout)

    def validate(self, val_loaders: dict, **kwargs) -> dict:
        """``utils.validation.validate`` with the EMA shadow in the model (as
        the reference validates); the model's own weights come back bit for
        bit afterwards, and the masters are not touched. Over a mesh, each
        rank validates its loaders (its rows of each dataset) and the
        metrics are gathered over the batch axes."""
        if self.layout is not None:  # tp peers hold the same rows: gather over the batch axes only
            kwargs.setdefault("group", self.layout.mesh.group("data", "fsdp"))
        with ema_weights(self.model, self.state.ema, self.layout):
            return validate(self.model, val_loaders, **kwargs)


def train_image_shape(config: dict, image_shape=None) -> tuple[int, int]:
    """The training image shape: ``image_shape`` or the config's, floored to
    the shape multiple (14), as the JAX trainer does."""
    mult = config["data"].get("augmentations", {}).get("shape_constraints", {}).get("shape_mult", 14)
    raw = image_shape or config["data"].get("image_shape", (480, 640))
    return tuple(int(s) // mult * mult for s in raw)


def num_encoder_layers(model: nn.Module) -> int:
    """The encoder's block count, layer decay's depth: a ViT's ``depth``, a
    ConvNeXt's blocks over all its stages."""
    enc = model.pixel_encoder
    return sum(enc.cfg.depths) if isinstance(enc, ConvNeXt) else enc.cfg.depth


def build_trainer(config: dict, device=None, seed: int = 13, image_shape=None, mesh: Mesh | None = None) -> Trainer:
    """The model ``config["model"]["name"]`` names (UniDepthV2 if none) on
    ``device`` (the card unless named; raises without one), weights from
    ``init_params(seed)`` drawn in float32 and kept as the masters, the model
    then cast to its compute dtype (bf16 on the card). UniDepthV1, a
    fixed-shape model, is built at the training image shape
    (``train_image_shape(config, image_shape)``), which is written into its
    ``data.image_shape`` as the JAX trainer does.

    ``mesh``: one rank of a multi-process run (``parallel.mesh.make_mesh``),
    on ``mesh.device``. Every rank draws the same whole weights, splits the
    model over tp and keeps its fsdp shards of the masters, moments and
    shadow."""
    device = resolve_device(mesh.device if mesh is not None else device)
    name = config["model"].get("name", "UniDepthV2")
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}: training takes {sorted(MODELS)}")
    if name == "UniDepthV1":
        config = copy.deepcopy(config)
        config.setdefault("data", {})["image_shape"] = list(train_image_shape(config, image_shape))
    model = MODELS[name].from_config(config, device=device, dtype=torch.float32).init_params(seed=seed)
    layout = None if mesh is None else Layout(mesh, shard_model_(model, mesh))
    params = master_params(model)
    model.to(dtype=compute_dtype(device))
    tr = config["training"]
    optimizer = build_optimizer(
        params,
        lr=tr.get("lr", 1e-4),
        lr_final=tr.get("lr_final", 1e-6),
        encoder_lr=config["model"]["pixel_encoder"].get("lr", 2e-6),
        wd=tr.get("wd", 0.1),
        wd_final=tr.get("wd_final", 0.1),
        warmup_iters=tr.get("warmup_iters", 75000),
        total_iters=tr.get("n_iters", 300000),
        ld=tr.get("ld", 1.0),
        num_encoder_layers=num_encoder_layers(model),
        clipping=tr.get("clipping", 1.0),
        cycle_betas=tr.get("cycle_beta", tr.get("cycle_betas", True)),
        lr_warmup=tr.get("lr_warmup", 1.0),
    )
    make = make_train_step_v1 if name == "UniDepthV1" else make_train_step
    init_state, train_step = make(model, optimizer, config, layout=layout)
    if layout is not None:
        params = layout.shard(params)
    return Trainer(model=model, optimizer=optimizer, state=init_state(params), train_step=train_step, layout=layout)
