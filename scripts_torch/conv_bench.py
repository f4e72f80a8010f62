#!/usr/bin/env python3
"""K5 conv3x3_lowchannel's bodies side by side on one CUDA card.

    python3 scripts_torch/conv_bench.py [--reps 10] [--runs 10]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Builds the kernels and prints what ptxas reported for the Hopper body
(``conv3x3_wgmma``, one line per instantiation: registers, spills). Then, at
the hr convs of the V2 heads in bf16, reflect padding, (8, 518, 518, Cin ->
32) for Cin = 64 (ViT-L/14), 48 (ViT-B/14) and 32 (ViT-S/14):

* holds the Hopper body against the plain version in fp32 on the same bf16
  inputs (max abs error, relative RMS error);
* times, in turns within this one process, the Hopper body
  (``conv3x3_lowchannel``), the mma.sync body of ``conv3x3.cu`` that served
  these calls before (its C entry called directly), and one ``F.conv2d``
  call (cuDNN, channels-last bf16, on the input padded beforehand: the
  library yardstick, never called by the port): CUDA events around
  ``--reps`` back-to-back calls, median of ``--runs``;
* prints each time with its share of the bound (x read once and the output
  written once over 3.35 TB/s, or the products over 989 TFLOP/s, whichever
  is larger) and the card's name and power limit, then one JSON line.
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
B, SIDE, COUT = 8, 518, 32
CINS = (64, 48, 32)
HBM_BYTES_S, BF16_FLOP_S = 3.35e12, 989e12


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
        raise SystemExit("conv_bench: no CUDA device")
    sys.path.insert(0, str(ROOT))
    from unidepth_tpu_torch.ops import _cuda
    from unidepth_tpu_torch.ops import conv_kernels as ck

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    lib = _cuda.library()
    for report in _cuda.ptxas_reports("conv3x3_wgmma"):
        text = "\n".join(report)
        name = re.search(r"conv3x3_wgmmaILi\d+ELi\d+EE", report[0])
        used = re.search(r"Used \d+ registers", text)
        spills = re.search(r"\d+ bytes spill stores, \d+ bytes spill loads", text)
        print(f"ptxas {name and name.group(0)}: {used and used.group(0)}, {spills and spills.group(0)}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(5)
    record = {"card": smi}
    calls, bounds = {}, {}
    for cin in CINS:
        x = torch.randn(B, SIDE, SIDE, cin, generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn(3, 3, cin, COUT, generator=gen, device="cuda") * (9 * cin) ** -0.5).to(torch.bfloat16)
        bias = (torch.randn(COUT, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
        out = torch.empty(B, SIDE, SIDE, COUT, dtype=torch.bfloat16, device="cuda")
        xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect").contiguous(memory_format=torch.channels_last)
        wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

        def mma_sync(x=x, w=w, bias=bias, out=out, cin=cin):
            _cuda.check(lib.ud_conv3x3_fwd(x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), B, SIDE, SIDE,
                                           cin, COUT, ck.PAD_MODES["reflect"], _cuda.DTYPE_CODES[torch.bfloat16],
                                           _cuda.stream_handle(x)), "ud_conv3x3_fwd")
            return out

        name = f"{cin}->{COUT}"
        calls[name] = lambda x=x, w=w, bias=bias: ck.conv3x3_lowchannel(x, w, bias, "reflect")
        calls[f"{name} mma.sync"] = mma_sync
        calls[f"{name} cudnn"] = lambda xp=xp, wl=wl, bias=bias: F.conv2d(xp, wl, bias)
        t_bytes = (x.numel() + out.numel()) * 2 / HBM_BYTES_S * 1e3
        t_ops = 2 * B * SIDE * SIDE * 9 * cin * COUT / BF16_FLOP_S * 1e3
        bounds[name] = max(t_bytes, t_ops)
        ref = ck.conv3x3_lowchannel_plain(x.float(), w.float(), bias.float(), "reflect")
        for body, fn in (("Hopper", calls[name]), ("mma.sync", mma_sync)):
            before = ck.conv3x3_lowchannel.hopper_launches
            got = fn()
            torch.cuda.synchronize()
            if body == "Hopper" and ck.conv3x3_lowchannel.hopper_launches != before + 1:
                raise RuntimeError(f"{name} did not launch the Hopper body")
            err = (got.float() - ref).abs().max().item()
            rel = ((got.float() - ref).norm() / ref.norm()).item()
            print(f"{name} {body} body: max_abs_err {err:.3e} rel_rms {rel:.3e}", flush=True)
            record[f"{name} {body}_rel_rms"] = rel
        del ref
    times = {name: [] for name in calls}
    for order in (list(calls), list(reversed(calls))):  # in turns: a, b, c, ..., c, b, a
        for name in order:
            times[name].append(event_ms(calls[name], args.reps, args.runs))
    for name, ts in times.items():
        ms = statistics.median(ts)
        shape = name.split()[0]
        record[f"{name}_ms"] = ms
        record[f"{shape}_bound_ms"] = bounds[shape]
        print(f"{name}: {ms:.4f} ms ({', '.join(f'{t:.4f}' for t in ts)}), {bounds[shape] / ms:.1%} of its "
              f"{bounds[shape]:.4f} ms bound ({smi})", flush=True)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
