"""How far the JAX package's own UniDepthV1 (ViT and ConvNeXt) and
UniDepthV2old train loss and gradients move in bf16, and how far its V1
int8 serving moves under its calibrated stage mask: the same weights and
batch in float32 and in bf16 (flax ``dtype``, float32 parameters) on the
CPU. The port's train gates for these families and its V1 int8 gate on the
card (``chip_smoke.py``, PERF.md section 2) are set from this, not from
the card.

    python tests/train_families_bf16_drift.py [--models v1-tiny ...] [--int8 v1-tiny ...]

Train models (each under its shipped config's training section; V1 takes
V1's loss slots, V2old V2's five, as the JAX trainer does; the seeded JAX
initialisation; one seeded ``collate``d Dummy batch of 2 images with the
ground-truth rays): ``v1-tiny`` (DINOv2 C = 64, 4 blocks; decoder hidden
64) at 28 x 56, ``v1-vits14`` (the ViT-S/14 encoder, C = 384, 12 blocks,
V1's output indices, under the shipped V1 decoder: hidden 512, depths (3,
2, 1)) at 168 x 224, ``v1-convnext-tiny`` (ConvNeXt depths (1, 1, 2, 1),
dims 32-256; decoder hidden 64) at 64 x 96, ``v1-convnext-large``
(configs/config_v1_cnvnxtl.json whole: ConvNeXt-L, 36 blocks of dims
192-1536, under the shipped decoder) at 96 x 128, ``v2old-tiny`` (C = 64, 4
blocks, the final norm; decoder hidden 64) at 28 x 56 and ``v2old-vits14``
(configs/config_v2old_vits14.json whole: ViT-S/14 under the hidden-512
decoder) at 168 x 224. One JSON line per model: each loss slot's relative
drift |bf16 - fp32| / |fp32| and the smallest per-parameter cosine between
the bf16 and fp32 gradients (over the parameters whose fp32 gradient is not
zero; a scanned stage's leaves split into their blocks, the port's
parameters), with its parameter, the 1st percentile and the median.
V2old's biases whose shift its whole-map log-depth norm or a softmax
removes (``SHIFT_INVARIANT``: the depth MLPs' last biases, the depth
conv's, the level embedding's LayerNorm bias, which shifts every key) have
a gradient that is zero in exact arithmetic and rounding noise in both
dtypes: they are left out of the cosines and listed apart.

Int8 models (``v1-tiny``, ``v1-vits14``; ``--int8``): the bf16 model
calibrates its stage mask (``calibrate_int8_stages``, the default budget
0.05) on 2 seeded uint8 images at the network shape, then serves 4 other
seeded images in int8 under that mask; depth and intrinsics against the
float32 model: median, mean, 99th percentile and max relative depth error,
max relative intrinsics error, and beside them bf16's without int8.
"""

import argparse
import json
import os
import re
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
from unidepth_tpu.models.backbones.convnext import ConvNeXt, ConvNeXtConfig  # noqa: E402
from unidepth_tpu.models.backbones.dinov2 import VIT_PRESETS, ViTConfig  # noqa: E402
from unidepth_tpu.models.unidepthv1.model import UniDepthV1  # noqa: E402
from unidepth_tpu.models.unidepthv2.old import UniDepthV2old  # noqa: E402
from unidepth_tpu.ops.flash_attention import safe_attention  # noqa: E402
from unidepth_tpu.training.losses import build_losses  # noqa: E402
from unidepth_tpu.training.step import compute_losses_v1, compute_losses_v2  # noqa: E402
from unidepth_tpu.utils.misc import normalize_rgb  # noqa: E402

TINY_VIT = dict(embed_dim=64, depth=4, num_heads=2, pos_embed_size=4, output_idx=(1, 2, 3, 4))
VITS = VIT_PRESETS["vits14"]
VITS_V1 = dict(embed_dim=VITS.embed_dim, depth=VITS.depth, num_heads=VITS.num_heads, output_idx=(3, 6, 9, 12))
MODELS = {  # family, encoder, decoder (hidden, depths, heads), shape, shipped config
    "v1-tiny": ("v1", TINY_VIT, (64, (1, 1, 1), 2), (28, 56), "config_v1_vitl14.json"),
    "v1-vits14": ("v1", VITS_V1, (512, (3, 2, 1), 8), (168, 224), "config_v1_vitl14.json"),
    "v1-convnext-tiny": ("v1", dict(depths=(1, 1, 2, 1), dims=(32, 64, 128, 256)), (64, (1, 1, 1), 2), (64, 96),
                         "config_v1_cnvnxtl.json"),
    "v1-convnext-large": ("v1", dict(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536)), (512, (3, 2, 1), 8),
                          (96, 128), "config_v1_cnvnxtl.json"),
    "v2old-tiny": ("v2old", TINY_VIT, (64, (1, 1, 1), 2), (28, 56), "config_v2old_vitl14.json"),
    "v2old-vits14": ("v2old", dict(embed_dim=VITS.embed_dim, depth=VITS.depth, num_heads=VITS.num_heads,
                                   output_idx=(9, 10, 11, 12)), (512, (6, 0, 0), 8), (168, 224),
                     "config_v2old_vits14.json"),
}
INT8_MODELS = ("v1-tiny", "v1-vits14")
# V2old's parameters whose gradient is rounding noise (see above), by key
SHIFT_INVARIANT = re.compile(r"\['depth_mlp_\d+'\]\['proj2'\]\['bias'\]|\['to_depth'\]\['conv'\]\['bias'\]"
                             r"|\['le_norm'\]\['bias'\]")


def build(name: str, dtype):
    family, enc, (hidden, depths, heads), shape, _ = MODELS[name]
    if family == "v2old":
        return UniDepthV2old(ViTConfig(**enc, use_norm=True), hidden_dim=hidden, decoder_depths=depths,
                             num_heads=heads, dtype=dtype)
    if "dims" in enc:
        encoder = ConvNeXt(cfg=ConvNeXtConfig(**enc), stacking="max_cls", dtype=dtype)
        return UniDepthV1(None, hidden_dim=hidden, decoder_depths=depths, num_heads=heads, image_shape=shape,
                          dtype=dtype, encoder_module=encoder)
    vit = ViTConfig(**enc, use_norm=False, interpolate_offset=0.1)
    return UniDepthV1(vit, hidden_dim=hidden, decoder_depths=depths, num_heads=heads, image_shape=shape, dtype=dtype)


def init(name: str, model):
    """``init_params(seed=0)`` with both inits jitted."""
    family, _, _, shape, _ = MODELS[name]
    k1, k2 = jax.random.split(jax.random.key(0))
    img = jnp.zeros((1, *shape, 3), jnp.float32)
    enc = jax.jit(model.encoder.init)(k1, img)
    feats, cls_tokens = jax.eval_shape(model.encoder.apply, enc, img)
    feats = [jnp.zeros(f.shape, jnp.float32) for f in feats]
    cls = [jnp.zeros(c.shape, jnp.float32) for c in cls_tokens]
    if family == "v2old":
        dec = jax.jit(model.decoder.init, static_argnums=4)(k2, feats, [cls[-3], cls[-2], cls[-1], cls[-2]],
                                                            [cls[-2], cls[-1]], shape)
    else:
        dec = jax.jit(model.decoder.init, static_argnums=3)(k2, feats, cls, shape)
    return {"encoder": enc["params"], "decoder": dec["params"]}


def run(name: str) -> dict:
    family, _, _, (h, w), shipped = MODELS[name]
    cfg = json.loads((ROOT / "configs" / shipped).read_text())
    recipe = compute_losses_v2 if family == "v2old" else compute_losses_v1
    params = init(name, build(name, jnp.float32))
    ds = Dummy(image_shape=(h, w), length=8)
    batch = {k: jnp.asarray(v) for k, v in collate([ds[0], ds[1]]).items()}
    losses = build_losses(cfg)
    out = {}
    for dtype in (jnp.float32, jnp.bfloat16):
        model = build(name, dtype)

        def loss_fn(p, b, model=model):
            with safe_attention():
                o = model.encode_decode(p, normalize_rgb(b["image"]), rays_gt=b["rays"])
            d = recipe(losses, o, b, jax.random.key(1))
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
    cosines, noise = {}, []
    for k, a in g32.items():
        b = g16[k]
        if family == "v2old" and SHIFT_INVARIANT.search(k):
            noise.append(k)
        elif np.any(a):
            cosines[k] = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-300))
    worst = min(cosines, key=cosines.get)
    return {"model": name, "shape": [h, w], "loss_fp32": s32, "loss_bf16": s16, "loss_rel_drift": drift,
            "max_loss_rel_drift": max(drift.values()), "min_grad_cosine": cosines[worst], "min_grad_cosine_param": worst,
            "grad_cosine_p1": float(np.percentile(list(cosines.values()), 1)),
            "grad_cosine_median": float(np.median(list(cosines.values()))), "params_compared": len(cosines),
            "shift_invariant_params": noise}


def run_int8(name: str) -> dict:
    _, _, _, (h, w), _ = MODELS[name]
    params = init(name, build(name, jnp.float32))
    rng = np.random.default_rng(0)
    calib = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    rgb = rng.integers(0, 256, (4, h, w, 3), dtype=np.uint8)
    ref_model = build(name, jnp.float32)
    ref_model.params = params
    ref = ref_model.infer(rgb)
    model = build(name, jnp.bfloat16)
    model.params = params
    bf16 = model.infer(rgb)
    report = model.calibrate_int8_stages(calib)
    model.set_serving_precision("int8")
    q = model.infer(rgb)

    def drift(out):
        d, d_ref = np.asarray(out["depth"], np.float64), np.asarray(ref["depth"], np.float64)
        rel = (np.abs(d - d_ref) / np.abs(d_ref)).ravel()
        k, k_ref = np.asarray(out["intrinsics"], np.float64), np.asarray(ref["intrinsics"], np.float64)
        return {"depth_median": float(np.median(rel)), "depth_mean": float(rel.mean()),
                "depth_p99": float(np.percentile(rel, 99)), "depth_max": float(rel.max()),
                "intrinsics_max": float((np.abs(k - k_ref) / (np.abs(k_ref) + 1e-6)).max())}

    return {"model": name, "shape": [h, w], "selected": report["selected"],
            "per_stage": report["per_stage"], "calibration_rel_err": report["rel_err"],
            "int8_vs_fp32": drift(q), "bf16_vs_fp32": drift(bf16)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", nargs="*", default=list(MODELS), choices=list(MODELS))
    ap.add_argument("--int8", nargs="*", default=list(INT8_MODELS), choices=list(INT8_MODELS))
    args = ap.parse_args()
    for name in args.models:
        print(json.dumps(run(name)), flush=True)
    for name in args.int8:
        print(json.dumps({"int8": run_int8(name)}), flush=True)


if __name__ == "__main__":
    main()
