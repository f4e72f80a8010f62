#!/usr/bin/env python3
"""K2 (LayerNorm -> fc1 -> exact GELU) bodies side by side on one CUDA card.

    python3 scripts_torch/ln_dense_bench.py [--iters 20] [--best-of 3]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Builds the kernels and prints what ptxas reported for the Hopper body
(``ln_dense_wgmma``, with its row statistics ``ln_row_stats``) and the
mma.sync body (``ln_dense_bf16``): registers, spills, shared memory. Then,
at the ViT-L block's shape (M = 8 x 1370 = 10960 tokens, C = 1024, F =
4096, eps 1e-6, GELU, bf16):

* holds both bodies against the plain version in fp32 on the same bf16
  inputs (max abs error, relative RMS error);
* times, in turns within this one process (a, b, c, d, d, c, b, a): the
  Hopper body (``ln_dense``, both launches), the mma.sync body of
  ``ln_dense.cu`` that served these calls before (its C entry called
  directly), the composed library yardstick ``F.layer_norm -> F.linear ->
  F.gelu`` in bf16 (three calls, never called by the port; no single
  PyTorch call computes the function) and, for scale, ``F.linear`` alone
  (cuBLAS, without the LN and the GELU); then the Hopper body's two
  launches apart: the row statistics alone, and the GEMM alone with and
  without the GELU (its C entries called directly). Each time is the best of
  ``--best-of`` runs of ``--iters`` back-to-back calls between two CUDA
  events;
* prints each time, its TFLOP/s (91.9 GFLOP a call) and share of the 989
  TFLOP/s bf16 dense peak, with the card's name and power limit, then one
  JSON line.
"""

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
M, C, FF, EPS = 8 * 1370, 1024, 4096, 1e-6
BF16_FLOP_S = 989e12


def best_ms(fn, iters, best_of):
    for _ in range(3):
        fn()
    times = []
    for _ in range(best_of):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return min(times)


def ptxas(cuda, kernel):
    """ptxas's registers and spill bytes for ``kernel``, with its report."""
    report = cuda.ptxas_report(kernel)
    text = "\n".join(report)
    regs = re.search(r"Used (\d+) registers", text)
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", text)]
    return report, (int(regs.group(1)) if regs else None), (sum(spills) if spills else None)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--best-of", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ln_dense_bench: no CUDA device")
    sys.path.insert(0, str(ROOT))
    from unidepth_tpu_torch.ops import _cuda
    from unidepth_tpu_torch.ops import fused_block as fb

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    lib = _cuda.library()
    record = {"card": smi}
    for kernel in ("ln_dense_wgmma", "ln_row_stats", "ln_dense_bf16"):
        report, regs, spills = ptxas(_cuda, kernel)
        print("\n".join(report) if report else f"ptxas report for {kernel}: none in the build log", flush=True)
        record[f"{kernel}_registers"], record[f"{kernel}_spill_bytes"] = regs, spills

    gen = torch.Generator(device="cuda").manual_seed(2)

    def randn(*shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std + mean).to(torch.bfloat16)

    x, w = randn(M, C, std=2.0, mean=0.5), randn(FF, C, std=C**-0.5)
    bias, gamma, beta = randn(FF, std=0.1), randn(C, std=0.1, mean=1.0), randn(C, std=0.1)
    b32, g32, bt32 = (t.float() for t in (bias, gamma, beta))
    out = torch.empty(M, FF, dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def mma_sync():
        _cuda.check(lib.ud_ln_dense_fwd(x.data_ptr(), w.data_ptr(), b32.data_ptr(), g32.data_ptr(), bt32.data_ptr(),
                                        out.data_ptr(), M, C, FF, EPS, 1, _cuda.DTYPE_CODES[x.dtype], stream),
                    "ln_dense mma.sync body")
        return out

    stats = torch.empty(M, 2, device="cuda")

    def row_stats():
        _cuda.check(lib.ud_ln_row_stats(x.data_ptr(), stats.data_ptr(), M, C, EPS, stream), "ln_row_stats")

    def gemm(gelu):
        _cuda.check(lib.ud_ln_dense_hopper_fwd(x.data_ptr(), w.data_ptr(), bias.data_ptr(), gamma.data_ptr(),
                                               beta.data_ptr(), stats.data_ptr(), out.data_ptr(), M, C, FF, gelu,
                                               1, stream), "ln_dense_wgmma")

    calls = {
        "hopper": lambda: fb.ln_dense(x, w, bias, gamma, beta, EPS, "gelu"),
        "mma.sync": mma_sync,
        "library": lambda: F.gelu(F.linear(F.layer_norm(x, (C,), gamma, beta, EPS), w, bias)),
        "linear": lambda: F.linear(x, w, bias),
        "stats alone": row_stats,
        "gemm alone": lambda: gemm(1),
        "gemm alone, no GELU": lambda: gemm(0),
    }
    ref = fb.ln_dense_plain(x.float(), w.float(), bias.float(), gamma.float(), beta.float(), EPS, "gelu")
    row_stats()
    for name in ("hopper", "mma.sync"):
        before = fb.ln_dense.hopper_launches
        got = calls[name]()
        torch.cuda.synchronize()
        if (fb.ln_dense.hopper_launches == before + 1) != (name == "hopper"):
            raise RuntimeError(f"{name}: the call did not take the body it names")
        err = (got.float() - ref).abs().max().item()
        rel = ((got.float() - ref).norm() / ref.norm()).item()
        print(f"{name} body: max_abs_err {err:.3e} rel_rms {rel:.3e}", flush=True)
        record[f"{name}_max_abs_err"], record[f"{name}_rel_rms"] = err, rel
    del ref
    times = {name: [] for name in calls}
    for order in (list(calls), list(reversed(calls))):
        for name in order:
            times[name].append(best_ms(calls[name], args.iters, args.best_of))
    flop = 2 * M * C * FF
    for name, ts in times.items():
        ms = min(ts)
        record[f"{name}_ms"] = ms
        print(f"{name}: {ms:.4f} ms (turns {', '.join(f'{t:.4f}' for t in ts)}), {flop / ms / 1e9:.1f} TFLOP/s, "
              f"{flop / ms / 1e-3 / BF16_FLOP_S:.1%} of peak ({smi})", flush=True)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
