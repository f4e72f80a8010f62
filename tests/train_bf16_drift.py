"""How far the JAX package's own UniDepthV2 train loss and gradients move in
bf16: the same weights and batch through its loss function in float32 and
in bf16 (flax ``dtype``, float32 parameters) on the CPU. The port's train
gate on the card (``chip_smoke.py``, PERF.md section 2) is set from this,
not from the card.

    python tests/train_bf16_drift.py [--models tiny vits14]

Each model takes the shipped ViT-L/14 config's training section (SILog,
SelfDistill, Regression, EdgeGuidedLocalSSI, Confidence), its seeded JAX
initialisation, and one seeded ``collate``d Dummy batch of 2 images, with
the ground-truth rays as in training. Models: ``tiny`` (DINOv2 C = 64, 4
blocks; decoder hidden 64) at 28 x 56, ``vits14`` (the ViT-S/14 encoder, C =
384, 12 blocks, under the shipped ViT-S/14 decoder, hidden 256) at 238 x
308, and ``vitl14`` (the shipped ViT-L/14 configuration whole: 24 blocks
of C = 1024, decoder hidden 512) at 182 x 238. Prints one JSON line per
model: each loss slot's relative drift |bf16 - fp32| / |fp32|, and the
smallest per-parameter cosine between the bf16 and fp32 gradients (over the
parameters whose fp32 gradient is not zero; a scanned stage's leaves split
into their blocks, the port's parameters), with its parameter and the 1st
percentile of the cosines.
"""

import argparse
import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from unidepth_tpu.datasets.dummy import Dummy  # noqa: E402
from unidepth_tpu.datasets.loader import collate  # noqa: E402
from unidepth_tpu.models.unidepthv2.model import UniDepthV2  # noqa: E402
from unidepth_tpu.ops.flash_attention import safe_attention  # noqa: E402
from unidepth_tpu.training.losses import build_losses  # noqa: E402
from unidepth_tpu.training.step import compute_losses_v2  # noqa: E402
from unidepth_tpu.utils.misc import normalize_rgb  # noqa: E402

MODELS = {
    "tiny": dict(encoder=dict(name="dinov2_vits14", embed_dim=64, depth=4, num_heads=2, pos_embed_size=4,
                              output_idx=[1, 2, 3, 4]),
                 decoder=dict(hidden_dim=64, out_dim=16, depths=[1, 1, 1]), heads=2, shape=(28, 56)),
    "vits14": dict(encoder=dict(name="dinov2_vits14", output_idx=[3, 6, 9, 12]),
                   decoder=dict(hidden_dim=256, out_dim=32, depths=[2, 2, 2]), heads=8, shape=(238, 308)),
    "vitl14": dict(encoder={}, decoder={}, heads=8, shape=(182, 238)),
}


def config_for(spec) -> dict:
    cfg = json.loads((ROOT / "configs/config_v2_vitl14.json").read_text())
    cfg["model"]["num_heads"] = spec["heads"]
    cfg["model"]["pixel_decoder"].update(spec["decoder"])
    cfg["model"]["pixel_encoder"].update(spec["encoder"])
    return cfg


def run(name: str) -> dict:
    spec = MODELS[name]
    cfg = config_for(spec)
    h, w = spec["shape"]
    m32 = UniDepthV2.from_config(cfg, dtype=jnp.float32)
    params = jax.jit(lambda: m32.init_params(seed=0, image_shape=(h, w)))()
    ds = Dummy(image_shape=(h, w), length=8)
    batch = {k: jnp.asarray(v) for k, v in collate([ds[0], ds[1]]).items()}
    losses = build_losses(cfg)
    out = {}
    for dtype in (jnp.float32, jnp.bfloat16):
        model = UniDepthV2.from_config(cfg, dtype=dtype)

        def loss_fn(p, b, model=model):
            with safe_attention():
                o = model.encode_decode(p, normalize_rgb(b["image"]), rays_gt=b["rays"])
            d = compute_losses_v2(losses, o, b, jax.random.key(1))
            return d["total"], d

        (_, slots), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, batch)
        leaves = {}
        for p, g in jax.tree_util.tree_leaves_with_path(grads):
            key, g = jax.tree_util.keystr(p), np.asarray(g, np.float64)
            if "stage_" in key:  # a scanned stage stacks its blocks: one parameter a block, as in the port
                leaves.update({f"{key}[{i}]": g[i].ravel() for i in range(g.shape[0])})
            else:
                leaves[key] = g.ravel()
        out[dtype] = ({k: float(v) for k, v in slots.items()}, leaves)
    (s32, g32), (s16, g16) = out[jnp.float32], out[jnp.bfloat16]
    drift = {k: abs(s16[k] - s32[k]) / abs(s32[k]) for k in s32}
    cosines = {}
    for k, a in g32.items():
        b = g16[k]
        if np.any(a):
            cosines[k] = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-300))
    worst = min(cosines, key=cosines.get)
    return {"model": name, "shape": [h, w], "loss_fp32": s32, "loss_bf16": s16, "loss_rel_drift": drift,
            "max_loss_rel_drift": max(drift.values()), "min_grad_cosine": cosines[worst], "min_grad_cosine_param": worst,
            "grad_cosine_p1": float(np.percentile(list(cosines.values()), 1)), "params_compared": len(cosines)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", nargs="+", default=list(MODELS), choices=list(MODELS))
    for name in ap.parse_args().models:
        print(json.dumps(run(name)), flush=True)


if __name__ == "__main__":
    main()
