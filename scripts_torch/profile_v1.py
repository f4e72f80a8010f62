#!/usr/bin/env python3
"""Where the time goes in a UniDepthV1 ``infer()`` of the PyTorch port, on
one CUDA card.

    python3 scripts_torch/profile_v1.py [--config configs/config_v1_cnvnxtl.json] [--batch 8]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Builds UniDepthV1 from the config (default ConvNeXt-L; random weights from
``init_params(seed=0)``, bf16 on the card) and, on seeded uint8 images at
the config's network shape (462x616):

* the encoder alone, the decoder alone (on the encoder's outputs) and the
  whole ``infer()``, timed with CUDA events (median of 3 rounds of 5);
* ``torch.profiler`` over 3 eager ``infer()`` calls (the stage graphs
  cleared before each, so the encoder and decoder run op by op and the
  labelled parts' hooks fire; the CUDA-event ``infer()`` time above is of
  the replayed graphs, the served path): the device's busy time (the
  union of the kernels' intervals), the span, the idle share 1 - busy /
  span and the kernels a call; for each labelled part (a
  ``record_function`` range opened by forward hooks around the encoder's
  depthwise convs, its pwconv2 linears, its stem and downsample convs, and
  around the decoder) the device time of the kernels its ops launched and
  the span of the range on the device; kernel K2 by its kernels' names
  (``ln_row_stats``, ``ln_dense_wgmma``); then the largest device-time
  entries. The profiler slows the calls it traces: its times are shares,
  the CUDA-event times the call's length.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
SEED = 0


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


def label_parts(model):
    """Forward hooks that open a ``record_function`` range named for each
    part; returns the hook handles."""
    from unidepth_tpu_torch.models.backbones.convnext import ConvNeXt, ConvNeXtBlock
    from unidepth_tpu_torch.models.backbones.dinov2 import ViTBlock

    parts = [(model.pixel_decoder, "part: decoder")]
    enc = model.pixel_encoder
    for m in enc.modules():
        if isinstance(m, ConvNeXtBlock):
            parts += [(m.conv_dw, "part: encoder depthwise 7x7 convs"), (m.mlp.fc2, "part: encoder pwconv2 (fc2)")]
        elif isinstance(m, ViTBlock):
            parts += [(m.attn.qkv, "part: encoder qkv"), (m.attn.proj, "part: encoder proj"),
                      (m.mlp.fc2, "part: encoder fc2")]
    if isinstance(enc, ConvNeXt):
        parts.append((enc.stem[0], "part: encoder stem and downsample convs"))
        parts += [(s.downsample[1], "part: encoder stem and downsample convs") for s in enc.stages if s.downsample]
    handles = []
    for module, name in parts:
        def pre(_m, _args, name=name):
            _m._profile_range = torch.profiler.record_function(name)
            _m._profile_range.__enter__()

        def post(_m, _args, _out):
            _m._profile_range.__exit__(None, None, None)

        handles += [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]
    return handles


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", default="configs/config_v1_cnvnxtl.json")
    parser.add_argument("--batch", type=int, default=8)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_v1: torch.cuda.is_available() is False")
    sys.path.insert(0, str(ROOT))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from unidepth_tpu_torch.models.unidepthv1.model import UniDepthV1

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    config = json.loads((ROOT / args.config).read_text())
    model = UniDepthV1.from_config(config).init_params(seed=SEED).eval()
    h, w = model.image_shape
    rgb = np.random.default_rng(SEED).integers(0, 256, (args.batch, h, w, 3), dtype=np.uint8)
    x = torch.randn(args.batch, h, w, 3, device="cuda").to(torch.bfloat16)
    calls = 3
    with torch.inference_mode():
        feats, cls_tokens = model.pixel_encoder(x)
        t_enc = event_ms(lambda: model.pixel_encoder(x))
        t_dec = event_ms(lambda: model.pixel_decoder(feats, cls_tokens, (h, w)))
        t_inf = event_ms(lambda: model.infer(rgb))
        del feats, cls_tokens
        handles = label_parts(model)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                model._stage_graphs.clear()  # eager: a replay runs no hook
                model.infer(rgb)
            torch.cuda.synchronize()
        for handle in handles:
            handle.remove()
    print(f"== {config['model']['pixel_encoder']['name']} B={args.batch} {h}x{w}: encoder {t_enc:.2f} ms, "
          f"decoder {t_dec:.2f} ms, infer {t_inf:.2f} ms (CUDA events, median of 3 rounds of 5)")
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, span = busy_and_span_us(kernels)
    print(f"device busy {busy / calls / 1e3:.2f} ms/call in a {span / calls / 1e3:.2f} ms span: "
          f"idle share {100 * (1 - busy / span):.2f}%, {len(kernels) / calls:.0f} kernels/call")
    averages = prof.key_averages()
    # each part twice: the device time of the kernels its ops launched (the
    # host-side range) and the span of its range on the device, gaps included
    for row in sorted((r for r in averages if r.key.startswith("part: ")), key=lambda r: (r.key, str(r.device_type))):
        what = "span on the device" if row.device_type == DeviceType.CUDA else "kernels of its ops"
        print(f"  {device_us(row) / calls / 1e3:8.3f} ms/call  {row.count / calls:6.0f}x  {row.key} ({what})")
    k2 = [r for r in averages if r.device_type == DeviceType.CUDA and ("ln_dense_wgmma" in r.key or "ln_row_stats" in r.key)]
    print(f"  {sum(map(device_us, k2)) / calls / 1e3:8.3f} ms/call  {sum(r.count for r in k2) / calls:6.0f}x  "
          "kernel K2 (ln_row_stats + ln_dense_wgmma)")
    rows = [k for k in averages if k.device_type == DeviceType.CUDA and device_us(k) > 0]
    for k in sorted(rows, key=device_us, reverse=True)[:24]:
        print(f"  {device_us(k) / calls / 1e3:8.3f} ms/call  {k.count / calls:6.0f}x  {k.key[:110]}")


if __name__ == "__main__":
    main()
