"""UniDepthV2 served through ``UniDepthV2.infer`` (the program) and its plain
reference (``benchmark/reference/v2.py``)."""

from __future__ import annotations

import torch

from benchmark.reference import v2 as reference

#: outputs a request brings to host memory before it counts as done
HOST_OUTPUTS = ("depth", "intrinsics")
#: outputs compared with the reference (those not in HOST_OUTPUTS are
#: copied for the sampled requests only, after their latency is taken)
CHECKED_OUTPUTS = ("depth", "confidence", "intrinsics")

#: the served output the reference is conditioned on when it judges the
#: others: V2's depth head takes its rays from the camera head's K, and at
#: random weights its high-frequency ray features turn a 0.2% gap in K into
#: a 2-4% gap in one image's depth scale; so the reference judges the camera
#: head on K and the depth and confidence heads given the served K, as a
#: served language model's logits are judged given its served tokens
CONDITION_ON = "intrinsics"

network_shape = reference.network_shape
infer_reference = reference.infer


def build(config: dict, device, dtype: torch.dtype):
    """The program's model on ``device`` in ``dtype``, built there."""
    from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2

    with torch.device(device):
        return UniDepthV2.from_config(config, device=device, dtype=dtype).eval()


def serve(model, rgb):
    """One request: ``infer`` with its default outputs."""
    return model.infer(rgb)


def stages(model) -> dict:
    """The modules ``infer`` calls, for the traced run's span hooks."""
    return {"encoder": model._serving_encoder(), "decoder": model.pixel_decoder}
