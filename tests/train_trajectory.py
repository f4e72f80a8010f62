"""The JAX package's UniDepthV1 or UniDepthV2old trainer and the port's,
side by side on the CPU in float32: the same weights (JAX's seeded
initialisation, carried to the port by ``from_jax_train_state``), the same
seeded ``collate``d Dummy batch of 2 x 2 images every step, the shipped
config's training section whole (V1's recipe for V1, V2's for V2old).
Prints each step's total loss and gradient norm from both.

    python tests/train_trajectory.py [--config configs/config_v1_vitl14.json] [--shape 112 154] [--steps 5]

At random weights the recipe's loss can rise over its first steps in JAX
as in the port (the config's learning rate starts at its peak:
``lr_warmup`` 1.0), so a falling loss over five steps is no test of these
trainers; ``chip_smoke.py`` holds their steps to first-order descent
instead (PERF.md section 6). Keep the shape small: a ViT-L/14 step
at 476 x 630 takes minutes and tens of GB of host memory on the CPU.
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

from unidepth_tpu.models.unidepthv1.model import UniDepthV1  # noqa: E402
from unidepth_tpu.models.unidepthv2.old import UniDepthV2old  # noqa: E402
from unidepth_tpu.training.optim import build_optimizer  # noqa: E402
from unidepth_tpu.training.step import make_train_step, make_train_step_v1  # noqa: E402
from unidepth_tpu_torch.datasets.dummy import Dummy  # noqa: E402
from unidepth_tpu_torch.datasets.loader import make_batch  # noqa: E402
from unidepth_tpu_torch.io.convert import from_jax_train_state  # noqa: E402
from unidepth_tpu_torch.training.trainer import build_trainer, num_encoder_layers  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=str(ROOT / "configs" / "config_v1_vitl14.json"))
    ap.add_argument("--shape", type=int, nargs=2, default=(112, 154))
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    cfg = json.loads(Path(args.config).read_text())
    cfg["data"]["image_shape"] = list(args.shape)
    cfg["training"]["batch_size"] = 2
    tr = cfg["training"]
    v1 = cfg["model"]["name"] == "UniDepthV1"
    if v1:
        jm = UniDepthV1.from_config(cfg, dtype=jnp.float32)
        params = jax.jit(lambda: jm.init_params(seed=0))()
    else:
        jm = UniDepthV2old.from_config(cfg, dtype=jnp.float32)
        params = jax.jit(lambda: jm.init_params(seed=0, image_shape=tuple(args.shape)))()
    trainer = build_trainer(cfg, device="cpu", seed=0)
    opt = build_optimizer(params, lr=tr["lr"], lr_final=tr["lr_final"], encoder_lr=2e-6, wd=tr["wd"],
                          wd_final=tr["wd_final"], warmup_iters=tr["warmup_iters"], total_iters=tr["n_iters"],
                          ld=tr["ld"], num_encoder_layers=num_encoder_layers(trainer.model), clipping=tr["clipping"],
                          cycle_betas=tr["cycle_beta"])
    init_state, step = (make_train_step_v1 if v1 else make_train_step)(jm, opt, cfg)
    state = init_state(params)
    step = jax.jit(step)
    trainer.state = from_jax_train_state(state, cfg, list(trainer.state.params))
    batch = make_batch(Dummy(image_shape=tuple(args.shape), length=1024, seed=0), 2, 2, np.random.default_rng(0))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rows = []
    for i in range(args.steps):
        state, jm_metrics = step(state, jbatch, jax.random.key(i))
        metrics = trainer.step(batch, (0, i))
        rows.append({"step": i + 1, "jax_total": float(jm_metrics["total"]), "port_total": float(metrics["total"]),
                     "jax_grad_norm": float(jm_metrics["grad_norm"]), "port_grad_norm": float(metrics["grad_norm"])})
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"config": Path(args.config).name, "shape": list(args.shape),
                      "jax": [r["jax_total"] for r in rows], "port": [r["port_total"] for r in rows]}))


if __name__ == "__main__":
    main()
