#!/usr/bin/env python3
"""The attention bodies side by side on one CUDA card.

    python3 scripts_torch/attention_bench.py [--reps 10] [--runs 10]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Builds the kernels and prints what ptxas reported for the Hopper body
(``attn_fwd_wgmma``, the instantiation K1, K3 and K4 launch: registers,
spills, shared memory). Then, at the ViT-L
serving shape (B=8, N=1370, 16 heads of 64, bf16, scale 1/8) for K1
(``flash_attention_qkv`` on one contiguous (8, 1370, 3072) projection) and
K4 (``flash_attention_packed`` on its three strided channel views), and at
the V2 decoders' cross-attention shapes for K3 (``flash_attention`` on flat
(BH, 1369, D) tensors, 8 heads an image): ViT-L's (64, 1369, 64) at B = 8,
ViT-B's (16, 1369, 48) at B = 2 and (64, 1369, 48) at B = 8, ViT-S's (64,
1369, 32) at B = 8:

* holds the Hopper body against the plain version in fp32 on the same bf16
  inputs (max abs error, relative RMS error);
* times, in turns within this one process, the Hopper body, the mma.sync
  body of ``attention.cu`` that served these calls before (its C entry
  called directly), and one ``F.scaled_dot_product_attention`` call on the
  same views (the library yardstick, never called by the port): CUDA events
  around ``--reps`` back-to-back calls, median of ``--runs``;
* prints each time, its ratio to SDPA at the same shape, its TFLOP/s (61.5
  GFLOP a K1/K4 call, 30.7 a K3 call at D = 64) and its share of the 989
  TFLOP/s bf16 dense peak, with the card's name and power limit, then one
  JSON line.
"""

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
B, N, HEADS, D = 8, 1370, 16, 64
N3 = 1369  # K3: 37 x 37 queries and keys
# K3's rows: name -> (BH, D); 8 heads an image
K3_SHAPES = {"K3": (64, 64), "K3 d48 B2": (16, 48), "K3 d48": (64, 48), "K3 d32": (64, 32)}
SCALE = D**-0.5
BF16_FLOP_S = 989e12


def event_ms(fn, reps, runs):
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--runs", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attention_bench: no CUDA device")
    sys.path.insert(0, str(ROOT))
    from unidepth_tpu_torch.ops import _cuda
    from unidepth_tpu_torch.ops import flash_attention as fa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    _cuda.library()
    report = _cuda.ptxas_report(fa.HOPPER_KERNEL)
    print("\n".join(report) if report else "ptxas report: none in the build log", flush=True)
    regs = re.search(r"Used (\d+) registers", "\n".join(report))

    gen = torch.Generator(device="cuda").manual_seed(1)
    qkv = torch.randn(B, N, 3 * HEADS * D, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = qkv.split(HEADS * D, dim=-1)
    c = HEADS * D
    views = [t.view(B, N, HEADS, D).transpose(1, 2) for t in (q, k, v)]
    out = torch.empty(B, N, c, dtype=torch.bfloat16, device="cuda")
    strides = (N * 3 * c, 3 * c) * 3 + (N * c, c)

    def mma_sync():
        fa._launch("mma.sync body", q, k.data_ptr(), v.data_ptr(), out, B, HEADS, N, N, D, strides, SCALE)

    flop = 4 * B * N * N * c
    calls = {  # name: (call, FLOP a call, the SDPA row at its shape)
        "K1": (lambda: fa.flash_attention_qkv(qkv, HEADS, SCALE), flop, "sdpa"),
        "K4": (lambda: fa.flash_attention_packed(q, k, v, HEADS, SCALE), flop, "sdpa"),
        "mma.sync": (mma_sync, flop, "sdpa"),
        "sdpa": (lambda: F.scaled_dot_product_attention(*views, scale=SCALE), flop, "sdpa"),
    }
    refs = {"K1": fa.flash_attention_qkv_plain(qkv.float(), HEADS, SCALE)}
    refs["K4"] = refs["K1"]
    for name, (bh, d) in K3_SHAPES.items():
        q3, k3, v3 = (torch.randn(bh, N3, d, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
        out3, scale3, flop3 = torch.empty_like(q3), d**-0.5, 4 * bh * N3 * N3 * d

        def k3_mma_sync(q3=q3, k3=k3, v3=v3, out3=out3, bh=bh, d=d, scale3=scale3):
            fa._launch("K3 mma.sync body", q3, k3.data_ptr(), v3.data_ptr(), out3, bh, 1, N3, N3, d,
                       (N3 * d, d) * 4, scale3)

        calls[name] = (lambda q3=q3, k3=k3, v3=v3, s=scale3: fa.flash_attention(q3, k3, v3, s), flop3, f"{name} sdpa")
        calls[f"{name} mma.sync"] = (k3_mma_sync, flop3, f"{name} sdpa")
        calls[f"{name} sdpa"] = (
            lambda q3=q3, k3=k3, v3=v3, s=scale3: F.scaled_dot_product_attention(q3[None], k3[None], v3[None], scale=s),
            flop3, f"{name} sdpa")
        refs[name] = fa.flash_attention_plain(q3.float(), k3.float(), v3.float(), scale3)
    record = {"card": smi, "registers": int(regs.group(1)) if regs else None}
    hopper = (fa.flash_attention_qkv, fa.flash_attention_packed, fa.flash_attention)
    for name, want in refs.items():
        before = sum(fn.hopper_launches for fn in hopper)
        got = calls[name][0]()
        torch.cuda.synchronize()
        if sum(fn.hopper_launches for fn in hopper) != before + 1:
            raise RuntimeError(f"{name} did not launch the Hopper body")
        err = (got.float() - want).abs().max().item()
        rel = ((got.float() - want).norm() / want.norm()).item()
        print(f"{name} Hopper body: max_abs_err {err:.3e} rel_rms {rel:.3e}", flush=True)
        record[f"{name}_rel_rms"] = rel
    times = {name: [] for name in calls}
    for order in (list(calls), list(reversed(calls))):  # in turns: a, b, c, d, d, c, b, a
        for name in order:
            times[name].append(event_ms(calls[name][0], args.reps, args.runs))
    for name, ts in times.items():
        ms = statistics.median(ts)
        _, fl, sdpa_name = calls[name]
        record[f"{name}_ms"] = ms
        print(f"{name}: {ms:.4f} ms ({', '.join(f'{t:.4f}' for t in ts)}), "
              f"{ms / statistics.median(times[sdpa_name]):.3f}x SDPA, {fl / ms / 1e9:.1f} TFLOP/s, "
              f"{fl / ms / 1e-3 / BF16_FLOP_S:.1%} of peak ({smi})", flush=True)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
