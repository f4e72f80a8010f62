#!/usr/bin/env python3
"""Where the time goes in bf16 and int8 serving of the PyTorch port, on one
CUDA card.

    python3 scripts_torch/profile_int8.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Builds UniDepthV2 ViT-L/14 (configs/config_v2_vitl14.json, random weights
from ``init_params(seed=0)``), then for each serving precision ('default',
i.e. bf16, and 'int8'):

* the encoder alone and depth-only ``infer()`` on 8 seeded 518x518 images,
  timed with CUDA events (median of 3 rounds of 5 calls);
* ``torch.profiler`` over 3 depth-only ``infer()`` calls: the device's busy
  time (the union of the kernels' intervals), the span from the first
  kernel's start to the last one's end, the idle share 1 - busy / span,
  the kernels a call, and the largest device-time entries.

Then each of the four int8 linears of a ViT-L block alone at M = 10960
tokens (B=8 x 1370): per-token quantize, ``torch._int_mm``, the fp32
dequant epilogue, the whole ``QuantLinear``, and a bf16 ``F.linear`` of the
same shape, each by CUDA events (median of 3 rounds of 20 calls).
"""

import json
import statistics
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
BATCH, SIDE, SEED, TOKENS = 8, 518, 0, 8 * 1370


def event_ms(fn, reps=5, rounds=3):
    """Median milliseconds per call: CUDA events around ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_us(evt):
    return getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)


def busy_and_span_us(kernels):
    """Union of the kernels' [start, end) intervals, and the whole span."""
    intervals = sorted((k.time_range.start, k.time_range.end) for k in kernels)
    busy, cur_s, cur_e = 0, *intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s, intervals[-1][1] - intervals[0][0]


def profile_mode(model, mode, rgb, calls=3, top=28):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model.set_serving_precision(mode)
    enc = model._serving_encoder()
    x = torch.randn(BATCH, SIDE, SIDE, 3, device="cuda").to(torch.bfloat16)
    with torch.inference_mode():
        t_enc = event_ms(lambda: enc(x))
        t_inf = event_ms(lambda: model.infer(rgb, outputs=("depth",)))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                model.infer(rgb, outputs=("depth",))
            torch.cuda.synchronize()
    print(f"== {mode}: encoder {t_enc:.2f} ms, infer depth-only {t_inf:.2f} ms "
          "(CUDA events, median of 3 rounds of 5)")
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, span = busy_and_span_us(kernels)
    print(f"device busy {busy / calls / 1e3:.2f} ms/call in a {span / calls / 1e3:.2f} ms span: "
          f"idle share {100 * (1 - busy / span):.2f}%, {len(kernels) / calls:.0f} kernels/call")
    rows = [k for k in prof.key_averages() if k.device_type == DeviceType.CUDA and device_us(k) > 0]
    for k in sorted(rows, key=device_us, reverse=True)[:top]:
        print(f"  {device_us(k) / calls / 1e3:8.3f} ms/call  {k.count / calls:6.0f}x  {k.key[:110]}")


def profile_linears():
    from unidepth_tpu_torch.ops.quant import QuantLinear, dynamic_quant, int8_matmul

    print(f"== int8 linears at M={TOKENS} (ms, CUDA events, median of 3 rounds of 20)")
    gen = torch.Generator().manual_seed(SEED)
    with torch.inference_mode():
        for name, k, n in (("qkv", 1024, 3072), ("proj", 1024, 1024), ("fc1", 1024, 4096), ("fc2", 4096, 1024)):
            x = torch.randn(TOKENS, k, generator=gen).to("cuda", torch.bfloat16)
            w = torch.randn(n, k, generator=gen) * k**-0.5
            layer = QuantLinear.from_float(w, torch.zeros(n), device="cuda")
            wb = w.to("cuda", torch.bfloat16)
            q, s = dynamic_quant(x)
            acc = int8_matmul(q, layer.weight)
            t_q = event_ms(lambda: dynamic_quant(x), 20)
            t_mm = event_ms(lambda: int8_matmul(q, layer.weight), 20)
            t_epi = event_ms(lambda: (acc.float() * (s * layer.scale) + layer.bias).to(torch.bfloat16), 20)
            t_all = event_ms(lambda: layer(x), 20)
            t_bf = event_ms(lambda: F.linear(x, wb), 20)
            ops = 2 * TOKENS * k * n
            print(f"  {name} ({k}->{n}): quantize {t_q:.4f}, _int_mm {t_mm:.4f} ({ops / t_mm / 1e9:.0f} TOP/s), "
                  f"dequant {t_epi:.4f}, QuantLinear {t_all:.4f}; bf16 F.linear {t_bf:.4f} "
                  f"({ops / t_bf / 1e9:.0f} TFLOP/s)")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_int8: torch.cuda.is_available() is False")
    sys.path.insert(0, str(ROOT))
    from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    warnings.simplefilter("ignore")  # resolution_level unset: default budget
    torch.backends.cuda.matmul.allow_tf32 = False
    config = json.loads((ROOT / "configs" / "config_v2_vitl14.json").read_text())
    model = UniDepthV2.from_config(config, device="cuda").init_params(seed=SEED).eval()
    rgb = np.random.default_rng(SEED).integers(0, 256, (BATCH, SIDE, SIDE, 3), dtype=np.uint8)
    for mode in ("default", "int8"):
        profile_mode(model, mode, rgb)
    profile_linears()


if __name__ == "__main__":
    main()
