"""How far the JAX package's own UniDepthV2 moves in bf16 under each encoder
stacking mode: the same weights run in float32 and in bf16 on the CPU,
depth compared with float32. The port's gate for the stacking modes other
than 'last' on the card (``chip_smoke.py`` ``STACKING_DEPTH_GATE``, PERF.md
section 2) is set from this, not from the card.

    python tests/stacking_bf16_drift.py

The model is the shipped ViT-S/14 config (configs/config_v2_vits14.json:
C = 384, 12 blocks, the final norm; decoder hidden 256, depths (2, 2, 2))
with its ``stacking_fn`` replaced, and once with 4 register tokens under
softmax stacking; the weights are the port's seeded initialisation
(``init_params(seed=0)``, the weights chip_smoke.py runs), carried into the
JAX model through the reference checkpoint keys (``convert_v2_state_dict``).
Two seeded uint8 518 x 518 images, as the smoke's ViT-S checks. Prints one
JSON line per case: the median, mean, 99th percentile and max relative
depth error against float32.
"""

import json
import os
import sys
import warnings
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from unidepth_tpu.io.convert import convert_v2_state_dict  # noqa: E402
from unidepth_tpu.models.unidepthv2.model import UniDepthV2  # noqa: E402
from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2 as PortV2  # noqa: E402

CASES = [("last", 0), ("max", 0), ("mean", 0), ("first", 0), ("softmax", 0), ("softmax", 4)]


def main():
    warnings.simplefilter("ignore")  # resolution_level unset: the default budget
    base = json.loads((ROOT / "configs" / "config_v2_vits14.json").read_text())
    rgb = np.random.default_rng(0).integers(0, 256, (2, 518, 518, 3), dtype=np.uint8)
    for stacking, reg in CASES:
        config = json.loads(json.dumps(base))
        config["model"]["pixel_encoder"].update(stacking_fn=stacking, num_register_tokens=reg)
        port = PortV2.from_config(config, device="cpu").init_params(seed=0)
        enc = port.encoder_cfg
        params = convert_v2_state_dict({k: v.numpy() for k, v in port.state_dict().items()},
                                       output_idx=enc.output_idx, num_register_tokens=reg, use_norm=enc.use_norm)
        out = {}
        for name, dtype in (("fp32", jnp.float32), ("bf16", jnp.bfloat16)):
            model = UniDepthV2.from_config(config, dtype=dtype)
            model.params = params
            out[name] = np.asarray(model.infer(rgb)["depth"], np.float64)
        r = np.abs(out["bf16"] - out["fp32"]) / np.abs(out["fp32"])
        print(json.dumps({"stacking": stacking, "register_tokens": reg, "depth_median_rel_err": float(np.median(r)),
                          "depth_mean_rel_err": float(r.mean()), "depth_p99_rel_err": float(np.quantile(r, 0.99)),
                          "depth_max_rel_err": float(r.max()), "device": jax.devices()[0].platform}), flush=True)


if __name__ == "__main__":
    main()
