#!/usr/bin/env python3
"""Where the time goes in a UniDepthV2old ``infer()`` of the PyTorch port, on
one CUDA card.

    python3 scripts_torch/profile_v2old.py [--config configs/config_v2old_vitl14.json] [--batch 8]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Builds UniDepthV2old from the config (random weights from
``init_params(seed=0)``, bf16 on the card, or int8 with ``--int8``) and, on
seeded uint8 images at the config's image shape (480x640, which the token
budget runs at 588x784):

* the encoder alone, the decoder alone (on the encoder's outputs) and the
  whole ``infer()``, timed with CUDA events (median of 3 rounds of 5);
* ``torch.profiler`` over 3 ``infer()`` calls: the device's busy time, the
  span, the idle share 1 - busy / span and the kernels a call; for each
  labelled part (a ``record_function`` range opened by forward hooks: the
  encoder's qkv, proj and fc2 GEMMs, and the decoder's adapters, camera
  head, global head, ``aggregate_16``, ``prompt_camera``, Nystrom blocks,
  each upsampler and the depth and confidence fusions) the device time of
  the kernels its ops launched; kernels K1, K2 and K4 by their kernels'
  names; then the largest device-time entries. The profiler slows the
  calls it traces: its times are shares, the CUDA-event times the call's
  length.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from profile_v1 import busy_and_span_us, device_us, event_ms

ROOT = Path(__file__).resolve().parents[1]
SEED = 0


def label_parts(model):
    """Forward hooks that open a ``record_function`` range named for each
    part; returns the hook handles."""
    from unidepth_tpu_torch.models.backbones.dinov2 import ViTBlock

    dec = model.pixel_decoder
    head = dec.depth_layer
    parts = [(dec, "part: decoder"), (dec.camera_layer, "part: decoder camera head"),
             (dec.global_layer, "part: decoder global head"), (head.aggregate_16, "part: decoder aggregate_16"),
             (head.prompt_camera, "part: decoder prompt_camera"),
             (head.to_depth, "part: decoder to_depth / to_confidence convs"),
             (head.to_confidence, "part: decoder to_depth / to_confidence convs")]
    parts += [(ad, "part: decoder adapters") for group in (dec.input_adapter, dec.camera_token_adapter,
                                                           dec.global_token_adapter) for ad in group.input_adapters]
    parts += [(blk, "part: decoder Nystrom blocks") for layers in head.process_layers for blk in layers]
    parts += [(up, f"part: decoder upsampler {i}") for i, up in enumerate(head.ups)]
    parts += [(mlp, "part: decoder depth / confidence MLPs") for mlps in (head.depth_mlp, head.confidence_mlp)
              for mlp in mlps]
    for m in model.pixel_encoder.modules():
        if isinstance(m, ViTBlock):
            parts += [(m.attn.qkv, "part: encoder qkv"), (m.attn.proj, "part: encoder proj"),
                      (m.mlp.fc2, "part: encoder fc2")]
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
    parser.add_argument("--config", default="configs/config_v2old_vitl14.json")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--int8", action="store_true", help="serve the encoder in int8")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_v2old: torch.cuda.is_available() is False")
    sys.path.insert(0, str(ROOT))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from unidepth_tpu_torch.models.unidepthv2.old import UniDepthV2old

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    config = json.loads((ROOT / args.config).read_text())
    model = UniDepthV2old.from_config(config).init_params(seed=SEED).eval()
    if args.int8:
        model.set_serving_precision("int8")
    image = tuple(config.get("data", {}).get("image_shape", (480, 640)))
    h, w = model._shapes(image)[0]
    rgb = np.random.default_rng(SEED).integers(0, 256, (args.batch, *image, 3), dtype=np.uint8)
    x = torch.randn(args.batch, h, w, 3, device="cuda").to(torch.bfloat16)
    encoder = model._serving_encoder()
    calls = 3
    with torch.inference_mode():
        feats, cls = encoder(x)
        cam, glob = [cls[-3], cls[-2], cls[-1], cls[-2]], [cls[-2], cls[-1]]
        t_enc = event_ms(lambda: encoder(x))
        t_dec = event_ms(lambda: model.pixel_decoder(feats, cam, glob, (h, w)))
        t_inf = event_ms(lambda: model.infer(rgb))
        del feats, cls, cam, glob
        handles = label_parts(model)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                model.infer(rgb)
            torch.cuda.synchronize()
        for handle in handles:
            handle.remove()
    mode = "int8" if args.int8 else "bf16"
    print(f"== V2old {config['model']['pixel_encoder']['name']} {mode} B={args.batch} {image[0]}x{image[1]} "
          f"(network {h}x{w}): encoder {t_enc:.2f} ms, decoder {t_dec:.2f} ms, infer {t_inf:.2f} ms (CUDA events, "
          "median of 3 rounds of 5)")
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, span = busy_and_span_us(kernels)
    print(f"device busy {busy / calls / 1e3:.2f} ms/call in a {span / calls / 1e3:.2f} ms span: "
          f"idle share {100 * (1 - busy / span):.2f}%, {len(kernels) / calls:.0f} kernels/call")
    averages = prof.key_averages()
    for row in sorted((r for r in averages if r.key.startswith("part: ") and r.device_type != DeviceType.CUDA),
                      key=lambda r: r.key):
        print(f"  {device_us(row) / calls / 1e3:8.3f} ms/call  {row.count / calls:6.0f}x  {row.key} (kernels of its ops)")
    for label, names in (("K1/K4 attn_fwd_wgmma", ("attn_fwd_wgmma",)), ("K2 ln_row_stats + ln_dense_wgmma",
                                                                           ("ln_dense_wgmma", "ln_row_stats"))):
        rows = [r for r in averages if r.device_type == DeviceType.CUDA and any(n in r.key for n in names)]
        print(f"  {sum(map(device_us, rows)) / calls / 1e3:8.3f} ms/call  {sum(r.count for r in rows) / calls:6.0f}x  "
              f"kernel {label}")
    rows = [k for k in averages if k.device_type == DeviceType.CUDA and device_us(k) > 0]
    for k in sorted(rows, key=device_us, reverse=True)[:24]:
        print(f"  {device_us(k) / calls / 1e3:8.3f} ms/call  {k.count / calls:6.0f}x  {k.key[:110]}")


if __name__ == "__main__":
    main()
