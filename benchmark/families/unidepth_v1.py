"""UniDepthV1 served through ``UniDepthV1.infer`` (the program) and its plain
reference (``benchmark/reference/v1.py``, the ConvNeXt encoder)."""

from __future__ import annotations

import torch

from benchmark.reference import v1 as reference

HOST_OUTPUTS = ("depth", "intrinsics")
CHECKED_OUTPUTS = ("depth", "intrinsics")

#: as for V2 (``unidepth_v2.CONDITION_ON``): the reference judges the camera
#: head on K and the depth given the served K
CONDITION_ON = "intrinsics"

network_shape = reference.network_shape
infer_reference = reference.infer


def build(config: dict, device, dtype: torch.dtype):
    from unidepth_tpu_torch.models.unidepthv1.model import UniDepthV1

    with torch.device(device):
        return UniDepthV1.from_config(config, device=device, dtype=dtype).eval()


def serve(model, rgb):
    return model.infer(rgb)


def stages(model) -> dict:
    return {"encoder": model._serving_encoder(), "decoder": model.pixel_decoder}
