"""UniDepthV2 with a SwiGLU DINOv2 encoder (ViT-g/14) served through
``UniDepthV2.infer`` (the program, served as ``unidepth_v2`` serves it) and
its plain reference (``benchmark/reference/v2_swiglu.py``)."""

from __future__ import annotations

import torch

from benchmark.families import unidepth_v2
from benchmark.families.unidepth_v2 import CHECKED_OUTPUTS, CONDITION_ON, HOST_OUTPUTS, serve, stages
from benchmark.reference import v2_swiglu as reference

__all__ = ["CHECKED_OUTPUTS", "CONDITION_ON", "HOST_OUTPUTS", "build", "infer_reference", "network_shape", "serve",
           "stages"]

network_shape = reference.network_shape
infer_reference = reference.infer


def build(config: dict, device, dtype: torch.dtype):
    """``unidepth_v2.build``, refused at once (ValueError) where the program
    did not build the configuration's encoder: the config's depth of SwiGLU
    blocks (``mlp.w12``) at its width, under the names the reference reads."""
    model = unidepth_v2.build(config, device, dtype)
    s = reference.model_sizes(config)
    params = dict(model.named_parameters())
    last = params.get(f"pixel_encoder.blocks.{s['depth'] - 1}.mlp.w12.weight")
    if last is None or last.shape[1] != s["embed_dim"] or f"pixel_encoder.blocks.{s['depth']}.norm1.weight" in params:
        raise ValueError(f"the program built no {s['depth']}-block SwiGLU encoder of width {s['embed_dim']} for "
                         f"{config['model']['pixel_encoder']['name']!r}")
    return model
