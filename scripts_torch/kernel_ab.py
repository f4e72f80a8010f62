#!/usr/bin/env python3
"""A/B microbench of the packed-attention variants on one NVIDIA GPU
(counterpart of scripts/kernel_ab.py; kernels K4, K6 and K7 of
unidepth_tpu_torch).

    python3 scripts_torch/kernel_ab.py [--iters 100] [--b 8] [--heads 16]
        [--n 1370] [--d 64] [--variants base,bf16p,lmxu,bf16p+lmxu,noexp,nomax]
        [--body hopper|mma.sync|both]

Every variant name of the JAX harness is accepted (see
``unidepth_tpu_torch.ops.kernel_ab`` for what each computes). Inputs are bf16
draws of ``np.random.default_rng(0)`` (q, then k, then v, each (B, N, H*D)),
scale D**-0.5. For each variant the script prints its time (CUDA events
around ``iters`` back-to-back calls, best of 3: the counterpart of the JAX
``time_chained``), its rate over the 4 B H N^2 D FLOP of one attention call,
and its max abs error against fp32 attention (``flash_attention_packed_plain``
on the same bf16 inputs); the variants that do not compute attention show a
large error by design, as in the JAX harness. The last column holds the
kernel against its own plain version, computed in fp32 on the same inputs:
relative RMS error ||out - ref|| / ||ref||. The first line is the card's name
and power limit.

``--body`` picks the kernel body: ``hopper`` (the default) goes through
``run_variant``, which at head dim 64 runs the wgmma + TMA body K1 runs;
``mma.sync`` calls the C entries of attention_ab.cu's mma.sync body (the
one that served K6/K7 at every head dim before) directly, with q pre-scaled
inside the call as ``run_variant`` does (``base``, K4, has no such row);
``both`` times the two in turn for each variant.

The script needs a CUDA card. ``run`` is its body, for callers such as
chip_smoke.py.
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from unidepth_tpu_torch.ops import _cuda  # noqa: E402
from unidepth_tpu_torch.ops.flash_attention import flash_attention_packed_plain  # noqa: E402
from unidepth_tpu_torch.ops.kernel_ab import FAMILY_CODES, family, run_variant, run_variant_plain  # noqa: E402

DEFAULT_VARIANTS = "base,bf16p,lmxu,bf16p+lmxu,noexp,nomax"
REL_RMS_BF16 = 5e-3
# p = s - rowmax with a divisor of 1e-30: outputs ~1e31, held by relative RMS alone
RELATIVE_ONLY = ("noexp",)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def make_inputs(b: int, heads: int, n: int, d: int, device="cuda"):
    rng = np.random.default_rng(0)
    return tuple(
        torch.from_numpy(rng.standard_normal((b, n, heads * d)).astype(np.float32)).to(device, torch.bfloat16)
        for _ in range(3)
    )


def time_chained(fn, iters: int) -> float:
    """Best of 3 runs of ``iters`` back-to-back calls, ms per call (CUDA events)."""
    fn()
    best = math.inf
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def run_mma_sync(variant: str, q, k, v, heads: int, scale: float):
    """``variant`` on attention_ab.cu's mma.sync body, its C entry called
    directly (the wrappers route head dim 64 to the Hopper body); contiguous
    bf16 (B, N, H*D) inputs."""
    if variant == "base":
        raise ValueError("base is K4: it has no mma.sync A/B row")
    qs = (q * scale).to(q.dtype)
    out = torch.empty_like(qs)
    (b, nq, c), nk = q.shape, k.shape[1]
    lib, stream = _cuda.library(), _cuda.stream_handle(q)
    ptrs = (qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if variant.startswith("bd"):
        err = lib.ud_attention_bd_fwd(*ptrs, b, heads, nq, nk, int("lmxu" in variant), stream)
    else:
        err = lib.ud_attention_ab_fwd(*ptrs, b, heads, nq, nk, c // heads, FAMILY_CODES[family(variant)], stream)
    _cuda.check(err, f"{variant} on the mma.sync body")
    return out


def rel_rms(out: torch.Tensor, ref: torch.Tensor) -> float:
    # normalised by the largest |ref| first, so ~1e31 outputs do not overflow the norm
    s = ref.abs().max().clamp(min=1e-30)
    return ((out.float() - ref) / s).norm().item() / (ref / s).norm().item()


def check_gates(variant: str, out: torch.Tensor, ref: torch.Tensor) -> float:
    """Hold a bf16 output against its plain version in fp32: elementwise at
    rtol 1.6e-2 and atol 1e-2 times the output's scale, max(1, max |ref|)
    (the unnormalised families are sums of ~N terms, ~10-100 in size), and
    at a relative RMS error <= 5e-3, the gate with teeth; ``noexp`` by
    relative RMS alone. Returns the relative RMS error."""
    if variant not in RELATIVE_ONLY:
        atol = 1e-2 * max(1.0, ref.abs().max().item())
        torch.testing.assert_close(out.float(), ref, rtol=1.6e-2, atol=atol, msg=lambda m: f"{variant}: {m}")
    rms = rel_rms(out, ref)
    if not rms <= REL_RMS_BF16:
        raise RuntimeError(f"{variant}: relative RMS error {rms:.3e} against its plain version > {REL_RMS_BF16}")
    return rms


def run(variants, iters=100, b=8, heads=16, n=1370, d=64, check=False, log=print, bodies=("hopper",)):
    """Time each variant on each of ``bodies`` ("hopper": ``run_variant``;
    "mma.sync": ``run_mma_sync``) and hold it against fp32 attention and
    against its own plain version; with ``check`` a variant outside the bf16
    gates (``check_gates``) raises. Returns one dict per variant and body."""
    c = heads * d
    scale = d**-0.5
    q, k, v = make_inputs(b, heads, n, d)
    qf, kf, vf = q.float(), k.float(), v.float()
    ref = flash_attention_packed_plain(qf, kf, vf, heads, scale)
    flops = 4 * n * n * d * b * heads
    log(f"shape B={b} H={heads} N={n} D={d}; {flops / 1e9:.1f} GFLOP/call")
    rows = []
    for variant in variants:
        plain = run_variant_plain(variant, qf, kf, vf, heads, scale)
        for body in bodies:
            call = run_variant if body == "hopper" else run_mma_sync
            out = call(variant, q, k, v, heads, scale)
            torch.cuda.synchronize()
            err = (out.float() - ref).abs().max().item()
            plain_err = (out.float() - plain).abs().max().item()
            rms = check_gates(variant, out, plain) if check else rel_rms(out, plain)
            if out.shape != (b, n, c) or not torch.isfinite(out).all():
                raise RuntimeError(f"{variant}: output malformed")
            ms = time_chained(lambda: call(variant, q, k, v, heads, scale), iters)
            log(f"{variant:>11} {body:>8}: {ms:7.3f} ms  {flops / ms / 1e9:6.1f} TFLOP/s  max-abs-err {err:.2e}  "
                f"plain rel-rms {rms:.2e}")
            rows.append({"variant": variant, "body": body, "ms": ms, "tflops": flops / ms / 1e9, "max_abs_err": err,
                         "plain_max_abs_err": plain_err, "plain_rel_rms": rms})
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--b", type=int, default=8)
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--n", type=int, default=1370)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--variants", default=DEFAULT_VARIANTS)
    ap.add_argument("--body", choices=("hopper", "mma.sync", "both"), default="hopper")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card (torch.cuda.is_available() is False)")
    print(smi_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    bodies = ("hopper", "mma.sync") if args.body == "both" else (args.body,)
    run(args.variants.split(","), args.iters, args.b, args.heads, args.n, args.d,
        log=lambda s: print(s, flush=True), bodies=bodies)


if __name__ == "__main__":
    main()
