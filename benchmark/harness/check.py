"""The comparison that decides ``correct``.

The sampled requests' outputs, as the timed path produced them, are held to
the family's plain float32 reference (TF32 off), run on the same uint8
images with the same weights, a few image rows at a time. Where the family
names a served output in ``CONDITION_ON`` (V2: the intrinsics), the
reference reads it to judge the outputs that depend on it, as a served
token is judged given the tokens served before it. Per image:

* ``depth_mean_rel``: mean over pixels of |depth - ref| / ref;
* ``depth_log_rel``: mean over pixels of |log depth - log ref| over
  max(1, |log ref|): a depth that is the exp of a logit rounded to bf16
  carries a relative error that grows with the logit, so where logits
  reach the clamp (V1: +-10) this number, not ``depth_mean_rel``, is
  steady from seed to seed;
* ``confidence_mean_rel``: the same for the confidence map, where the
  family serves one;
* ``intrinsics_max_rel``: the largest gap of fx, fy (over the reference's
  fx, fy) and of cx, cy (over the image's width, height).

Each number is the largest over every image of every sampled request, and
is held to the cell's limit where the cell sets one. ``numbers(...,
fp8=True)`` gives the same numbers for the control: the reference in fp8
in the program's place.
"""

from __future__ import annotations

import torch

from benchmark.reference.ops import Numerics

NUMBER_OF_OUTPUT = {"depth": "depth_mean_rel", "confidence": "confidence_mean_rel",
                    "intrinsics": "intrinsics_max_rel"}


def image_gaps(out: dict, ref: dict) -> dict:
    """Per image of a batch, each number of the outputs both sides have."""
    gaps = {}
    if "depth" in out and "depth" in ref:
        lr = torch.log(ref["depth"].float())
        gaps["depth_log_rel"] = ((torch.log(out["depth"].float()) - lr).abs() / lr.abs().clamp_min(1.0)).flatten(1).mean(1)
    for key in ("depth", "confidence"):
        if key in out and key in ref:
            r = ref[key].float()
            gaps[NUMBER_OF_OUTPUT[key]] = ((out[key].float() - r).abs() / r.abs()).flatten(1).mean(1)
    if "intrinsics" in out:
        p, r = out["intrinsics"].float(), ref["intrinsics"].float()
        h, w = out["depth"].shape[1:3]
        scale = torch.stack([r[:, 0, 0], r[:, 1, 1], torch.full_like(r[:, 0, 0], w), torch.full_like(r[:, 0, 0], h)], 1)
        pick = [(0, 0), (1, 1), (0, 2), (1, 2)]
        diff = torch.stack([(p[:, i, j] - r[:, i, j]).abs() for i, j in pick], 1)
        gaps["intrinsics_max_rel"] = (diff / scale).amax(1)
    return gaps


def reference_outputs(family, config, weights, rgb, fp8: bool, rows: int, given=None) -> dict:
    """The reference on ``rgb`` (uint8, on the reference's device), ``rows``
    images at a time, float32 with TF32 off; ``given``: the served output
    the family's reference is conditioned on (``CONDITION_ON``), or None."""
    matmul_tf32, cudnn_tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        parts = [family.infer_reference(Numerics(fp8=fp8), weights, config, rgb[i : i + rows],
                                        *(() if given is None else (given[i : i + rows],)))
                 for i in range(0, rgb.shape[0], rows)]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul_tf32, cudnn_tf32
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


@torch.no_grad()
def numbers(family, config, weights, sampled, device, rows: int = 4, fp8: bool = False,
            condition: bool = True) -> dict:
    """The largest of each number over the sampled requests: ``sampled`` is
    a list of (uint8 batch on the host, the program's outputs on the host).
    With ``fp8`` the control's outputs stand in the program's place; with
    ``condition=False`` the reference ignores ``CONDITION_ON`` (a reading
    kept beside the compared one, never compared)."""
    worst = {}
    condition = getattr(family, "CONDITION_ON", None) if condition else None
    for rgb, out in sampled:
        rgb = rgb.to(device)
        if fp8:
            out = reference_outputs(family, config, weights, rgb, True, rows)
        out = {k: v.to(device) for k, v in out.items()}
        ref = reference_outputs(family, config, weights, rgb, False, rows, out[condition] if condition else None)
        for name, g in image_gaps(out, ref).items():
            # a NaN or an infinity reads as an infinite gap, never as none
            g = torch.nan_to_num(g, nan=float("inf"))
            worst[name] = max(worst.get(name, 0.0), float(g.max()))
    return worst


def control(root, workload: str, seed: int):
    """The control as a ``fault`` of ``session.run``: the family's reference
    in fp8, with the weights of ``seed``, served in the program's place, so
    that a whole run of the cell can be seen to come out not correct."""
    from benchmark.harness import registry, weights as weights_mod

    cfg = registry.cell(root, workload)["config_file"]
    family = registry.family(cfg["family"])
    dtype = getattr(torch, cfg["dtype"])

    def fault(serve):
        served = {}

        @torch.no_grad()
        def fp8_reference(model, rgb):
            device = next(model.parameters()).device
            if not served:
                entries = weights_mod.spec(model, cfg["assumed"]["layer_scale"], cfg["assumed"].get("weight_scales"))
                served.update(weights_mod.served(weights_mod.draw(entries, seed, device), dtype))
            return reference_outputs(family, cfg["config"], served, rgb.to(device), True, 4)

        return fp8_reference

    return fault
