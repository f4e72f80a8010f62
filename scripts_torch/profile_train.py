#!/usr/bin/env python3
"""Where the time goes in one optimizer step of the PyTorch port's trainer,
on one CUDA card.

    python3 scripts_torch/profile_train.py [--config-file configs/config_v2_vitl14.json] [--steps 2]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Builds the trainer ``chip_smoke.py`` trains for the config (default
UniDepthV2 ViT-L/14; also UniDepthV1 ViT-L/14 or ConvNeXt-L, UniDepthV2old;
random weights from ``init_params(seed=0)``, bf16 on the card with fp32
masters) and one seeded Dummy batch of its training section's 8 x 2 images
at its floored training shape (476 x 630; V1 462 x 616), takes two warm-up
steps, times ``--steps`` steps with the host clock around
``torch.cuda.synchronize()``, then runs ``torch.profiler`` over one step and
prints:

* the device's busy time (the union of the kernels' intervals), the span,
  the idle share 1 - busy / span and the kernels a step;
* for each labelled part (a ``record_function`` range opened around a call
  on the host) the device time of the kernels its ops launched: the plain
  VJP backward of K1/K3/K4 and of K2 (the N x N attention recomputed in
  fp32), the encoder blocks' forward (ViT or ConvNeXt blocks, run twice:
  the forward and the backward's recompute), the decoder's forward, the
  losses' forward, the optimizer and the EMA;
* the kernels' forwards by name (K1 and K3 ``attn_fwd_wgmma``, K2
  ``ln_row_stats`` + ``ln_dense_wgmma``), then the largest device-time
  entries.
The profiler slows what it traces: its times are shares, the host-clock
step time is the step's length.
"""

import argparse
import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from profile_v1 import busy_and_span_us, device_us

ROOT = Path(__file__).resolve().parents[1]
SEED = 0


def labelled(fn, name):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return wrapper


def label_parts():
    """Wrap the step's parts in ``record_function`` ranges (module
    attributes, looked up at call time)."""
    from unidepth_tpu_torch.ops import flash_attention as fa
    from unidepth_tpu_torch.ops import fused_block as fb
    from unidepth_tpu_torch.training import optim, step

    for mod, attr, name in (
        (fa, "_flash_attention_qkv_bwd", "part: K1 backward (plain VJP)"),
        (fa, "_flash_attention_bwd", "part: K3 backward (plain VJP)"),
        (fa, "_flash_attention_packed_bwd", "part: K4 backward (plain VJP)"),
        (fb, "_ln_dense_bwd", "part: K2 backward (plain VJP)"),
        (step, "compute_losses_v2", "part: losses (forward)"),
        (step, "compute_losses_v1", "part: losses (forward)"),
        (step, "ema_update", "part: EMA"),
    ):
        setattr(mod, attr, labelled(getattr(mod, attr), name))
    optim.AdamW.apply = labelled(optim.AdamW.apply, "part: optimizer")


def label_modules(model):
    from unidepth_tpu_torch.models.backbones.convnext import ConvNeXtBlock
    from unidepth_tpu_torch.models.backbones.dinov2 import ViTBlock

    parts = [(model.pixel_decoder, "part: decoder (forward)")]
    parts += [(m, "part: encoder blocks (forward and recompute)") for m in model.modules()
              if isinstance(m, (ViTBlock, ConvNeXtBlock))]
    for module, name in parts:
        def pre(_m, _args, name=name):
            _m._profile_range = torch.profiler.record_function(name)
            _m._profile_range.__enter__()

        def post(_m, _args, _out):
            _m._profile_range.__exit__(None, None, None)

        module.register_forward_pre_hook(pre)
        module.register_forward_hook(post)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config-file", default=str(ROOT / "configs" / "config_v2_vitl14.json"))
    parser.add_argument("--steps", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: torch.cuda.is_available() is False")
    sys.path.insert(0, str(ROOT))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    label_parts()
    from unidepth_tpu_torch.datasets.dummy import Dummy
    from unidepth_tpu_torch.datasets.loader import make_batch
    from unidepth_tpu_torch.training.trainer import build_trainer, train_image_shape

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    config = json.loads(Path(args.config_file).read_text())
    tr = config["training"]
    shape = train_image_shape(config)
    trainer = build_trainer(config, seed=SEED)
    label_modules(trainer.model)
    batch = make_batch(Dummy(image_shape=shape, length=1024, seed=SEED), tr["batch_size"],
                       tr["nsteps_accumulation_gradient"], np.random.default_rng(SEED))
    images = tr["batch_size"] * tr["nsteps_accumulation_gradient"]
    for i in range(2):
        trainer.step(batch, (SEED, i))
    times = []
    for i in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step(batch, (SEED, 2 + i))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    family = f"{type(trainer.model).__name__} ({config['model']['pixel_encoder']['name']})"
    print(f"== train step {family}, {tr['nsteps_accumulation_gradient']} x {tr['batch_size']} images at "
          f"{shape[0]}x{shape[1]}: {ms:.1f} ms/step (median of {', '.join(f'{t:.1f}' for t in times)}), "
          f"{images / ms * 1e3:.2f} images/s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.step(batch, (SEED, 2 + args.steps))
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, span = busy_and_span_us(kernels)
    print(f"device busy {busy / 1e3:.2f} ms in a {span / 1e3:.2f} ms span under the profiler: idle share "
          f"{100 * (1 - busy / span):.2f}%, {len(kernels)} kernels a step")
    averages = prof.key_averages()
    for row in sorted((r for r in averages if r.key.startswith("part: ") and r.device_type != DeviceType.CUDA),
                      key=lambda r: -device_us(r)):
        print(f"  {device_us(row) / 1e3:9.3f} ms  {row.count:6d}x  {row.key} (kernels of its ops)")
    named = {"K1/K3/K4 forward (attn_fwd_wgmma)": ("attn_fwd_wgmma",),
             "K2 forward (ln_row_stats + ln_dense_wgmma)": ("ln_dense_wgmma", "ln_row_stats")}
    for label, keys in named.items():
        rows = [r for r in averages if r.device_type == DeviceType.CUDA and any(k in r.key for k in keys)]
        print(f"  {sum(map(device_us, rows)) / 1e3:9.3f} ms  {sum(r.count for r in rows):6d}x  kernel {label}")
    rows = [k for k in averages if k.device_type == DeviceType.CUDA and device_us(k) > 0]
    for k in sorted(rows, key=device_us, reverse=True)[:25]:
        print(f"  {device_us(k) / 1e3:9.3f} ms  {k.count:6d}x  {k.key[:110]}")


if __name__ == "__main__":
    main()
