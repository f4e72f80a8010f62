"""How far the JAX package's own UniDepthV1 moves in bf16: the same weights
run in float32 and in bf16 on the CPU, depth compared. The port's bf16 gate
for V1 on the card is set from this (PERF.md section 2), not from the card.

    python tests/v1_bf16_drift.py

Four models, each with the JAX package's seeded initialisation (the
distributions ``init_params`` draws, in the port too, and so the weights
chip_smoke.py runs): the ViT and ConvNeXt sizes of tests/test_torch_v1.py and
tests/test_torch_convnext.py, and two wider ones, a ViT-S/14 encoder (C =
384, 12 blocks) and a ConvNeXt at ConvNeXt-L's widths (depths (1, 1, 3,
1)), both under the shipped decoder (hidden 512, depths (3, 2, 1), 8 heads)
at 238 x 308. Prints one JSON line per model: the median and max relative
depth error of bf16 against float32, over 2 seeded uint8 images.
"""

import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from unidepth_tpu.models.backbones.convnext import ConvNeXt, ConvNeXtConfig  # noqa: E402
from unidepth_tpu.models.backbones.dinov2 import ViTConfig  # noqa: E402
from unidepth_tpu.models.unidepthv1.model import UniDepthV1  # noqa: E402

SMALL_VIT = ViTConfig(embed_dim=64, depth=4, num_heads=2, pos_embed_size=8, output_idx=(1, 2, 3, 4), use_norm=False,
                      interpolate_offset=0.1)
VITS = ViTConfig(embed_dim=384, depth=12, num_heads=6, output_idx=(3, 6, 9, 12), use_norm=False, interpolate_offset=0.1)
MODELS = {
    "vit-small-test": dict(vit=SMALL_VIT, hidden=32, depths=(1, 1, 1), heads=4, shape=(56, 70)),
    "convnext-small-test": dict(convnext=ConvNeXtConfig(depths=(1, 1, 2, 1), dims=(32, 64, 128, 256)), hidden=32,
                                depths=(1, 1, 1), heads=4, shape=(64, 96)),
    "vits14-decoder512": dict(vit=VITS, hidden=512, depths=(3, 2, 1), heads=8, shape=(238, 308)),
    "convnext-l-widths-decoder512": dict(convnext=ConvNeXtConfig(depths=(1, 1, 3, 1)), hidden=512, depths=(3, 2, 1),
                                         heads=8, shape=(238, 308)),
}


def build(spec, dtype):
    encoder = None
    if "convnext" in spec:
        encoder = ConvNeXt(cfg=spec["convnext"], stacking="max_cls", dtype=dtype)
    return UniDepthV1(spec.get("vit"), hidden_dim=spec["hidden"], decoder_depths=spec["depths"], num_heads=spec["heads"],
                      image_shape=spec["shape"], dtype=dtype, encoder_module=encoder)


def init(m, seed):
    k1, k2 = jax.random.split(jax.random.key(seed))
    img = jnp.zeros((1, *m.image_shape, 3), jnp.float32)
    enc = jax.jit(m.encoder.init)(k1, img)
    feats, cls_tokens = jax.eval_shape(m.encoder.apply, enc, img)
    zeros = [[jnp.zeros(t.shape, jnp.float32) for t in ts] for ts in (feats, cls_tokens)]
    dec = jax.jit(m.decoder.init, static_argnums=3)(k2, *zeros, m.image_shape)
    return {"encoder": enc["params"], "decoder": dec["params"]}


def main():
    for name, spec in MODELS.items():
        m32, m16 = build(spec, jnp.float32), build(spec, jnp.bfloat16)
        m32.params = m16.params = init(m32, 0)
        rgb = np.random.default_rng(1).integers(0, 256, (2, *spec["shape"], 3), dtype=np.uint8)
        d32 = np.asarray(m32.infer(rgb)["depth"], np.float64)
        d16 = np.asarray(m16.infer(rgb)["depth"], np.float64)
        rel = np.abs(d16 - d32) / np.abs(d32)
        print(json.dumps({"model": name, "depth_median_rel_err": float(np.median(rel)), "depth_max_rel_err": float(rel.max()),
                          "device": jax.devices()[0].platform}), flush=True)


if __name__ == "__main__":
    main()
