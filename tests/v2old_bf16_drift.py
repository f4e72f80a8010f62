"""How far the JAX package's own UniDepthV2old moves in bf16 and in int8:
the same weights run in float32, in bf16 and in bf16 with the int8 encoder
on the CPU, depth and intrinsics compared with float32. The port's V2old
gates on the card (``chip_smoke.py``, PERF.md section 2) are set from this,
not from the card.

    python tests/v2old_bf16_drift.py

The weights are the port's seeded initialisation (``init_params(seed=0)``,
the weights chip_smoke.py runs), carried into the JAX model through the
reference checkpoint keys (``convert_v2old_state_dict``). Two models: the
size of tests/test_torch_v2old.py (ViT C = 64, 4 blocks; decoder hidden 32,
depths (1, 1, 1)) on 56 x 70 images, and the ViT-S/14 encoder (C = 384, 12
blocks, the shipped ViT-S config's output_idx and final norm) under the
shipped decoder (hidden 512, depths (6, 0, 0), 8 heads) on 240 x 320
images at a 300-token budget (210 x 280, 15 x 20 patches: more than the
Nystrom blocks' 128 landmarks). Prints one JSON line per model and
precision: the median, mean, 99th percentile and max relative depth error
and the max relative intrinsics error against float32, over 2 seeded uint8
images.
"""

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

from unidepth_tpu.io.convert import convert_v2old_state_dict  # noqa: E402
from unidepth_tpu.models.backbones.dinov2 import ViTConfig  # noqa: E402
from unidepth_tpu.models.unidepthv2.old import UniDepthV2old  # noqa: E402
from unidepth_tpu_torch.models.unidepthv2.old import UniDepthV2old as PortV2old  # noqa: E402

MODELS = {
    "tiny-test": dict(encoder=dict(name="dinov2_vits14", embed_dim=64, depth=4, num_heads=2, pos_embed_size=8,
                                   output_idx=[1, 2, 3, 4], use_norm=True),
                      hidden=32, depths=[1, 1, 1], heads=2, bounds=(12, 30), shape=(56, 70)),
    "vits14-decoder512": dict(encoder=dict(name="dinov2_vits14", output_idx=[9, 10, 11, 12], use_norm=True),
                              hidden=512, depths=[6, 0, 0], heads=8, bounds=(300, 300), shape=(240, 320)),
}


def config_for(spec) -> dict:
    return {"model": {"name": "UniDepthV2old", "num_heads": spec["heads"], "expansion": 4,
                      "pixel_decoder": {"hidden_dim": spec["hidden"], "depths": spec["depths"]},
                      "pixel_encoder": spec["encoder"]}}


def jax_model(spec, port, dtype):
    enc = port.encoder_cfg
    vit = ViTConfig(embed_dim=enc.embed_dim, depth=enc.depth, num_heads=enc.num_heads,
                    pos_embed_size=enc.pos_embed_size, output_idx=enc.output_idx, use_norm=enc.use_norm)
    return UniDepthV2old(vit, hidden_dim=spec["hidden"], decoder_depths=tuple(spec["depths"]), num_heads=spec["heads"],
                         pixels_bounds=spec["bounds"], dtype=dtype)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.abs(b)


def main():
    for name, spec in MODELS.items():
        port = PortV2old.from_config(config_for(spec), device="cpu").init_params(seed=0)
        sd = {k: v.numpy() for k, v in port.state_dict().items()}
        params = convert_v2old_state_dict(sd, output_idx=port.encoder_cfg.output_idx, use_norm=port.encoder_cfg.use_norm)
        rgb = np.random.default_rng(1).integers(0, 256, (2, *spec["shape"], 3), dtype=np.uint8)
        m32 = jax_model(spec, port, jnp.float32)
        m32.params = params
        ref = m32.infer(rgb)
        m16 = jax_model(spec, port, jnp.bfloat16)
        m16.params = params
        for precision in ("bf16", "int8"):
            m16.set_serving_precision("default" if precision == "bf16" else "int8")
            out = m16.infer(rgb)
            r = rel(out["depth"], ref["depth"])
            k = np.abs(np.asarray(out["intrinsics"], np.float64) - np.asarray(ref["intrinsics"], np.float64)) / (
                np.abs(np.asarray(ref["intrinsics"], np.float64)) + 1e-6)
            print(json.dumps({"model": name, "precision": precision, "network_shape": m16._shapes(spec["shape"])[0],
                              "depth_median_rel_err": float(np.median(r)), "depth_mean_rel_err": float(r.mean()),
                              "depth_p99_rel_err": float(np.quantile(r, 0.99)), "depth_max_rel_err": float(r.max()),
                              "intrinsics_max_rel_err": float(k.max()), "device": jax.devices()[0].platform}),
                  flush=True)


if __name__ == "__main__":
    main()
