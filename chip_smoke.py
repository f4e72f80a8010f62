#!/usr/bin/env python3
"""Smoke test of the PyTorch port (unidepth_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc. It
fails (non-zero exit, no result line) without CUDA or outside a checkout.

1. Prints the card's name and power limit and builds the CUDA kernels from
   ``unidepth_tpu_torch/csrc`` with nvcc.
2. One phase per kernel at the shapes its path gives it (K4: strided views
   of one (8, 1370, 3072) projection, 16 heads, scale 1/8). In bf16 I/O
   it runs the tensor-core kernels that the paths launch
   (attn_fwd_bf16, ln_dense_bf16) and holds them against the plain PyTorch
   version computed in fp32 on the same bf16 inputs: elementwise at rtol
   1.6e-2, atol 1e-2 (bf16 output rounding), and at a relative RMS error
   ||out - ref|| / ||ref|| <= 5e-3, which rounding alone keeps near 2e-3
   and a 2% error in the softmax denominator (the ragged-tile mask lost)
   exceeds. In fp32 I/O it runs the CUDA-core kernels of the same sources
   (attn_fwd_simt, ln_dense_simt), which the main path does not launch, at
   1e-4 (attention) and 2e-4 (ln_dense). It times kernel and plain version
   in bf16 (CUDA events around 10 back-to-back calls, median of 10 runs).
3. The kernels whose entry points are not a model path (K5-K7): K5
   conv3x3_lowchannel at the V2 heads' hr conv shape, (8, 518, 518, 64 ->
   32) reflect, in bf16 and fp32 like the others, then zeros, reflect and
   replicate padding at small ragged shapes; then K5's entry alone (one
   call: 1 launch). K6, the A/B harness of
   scripts_torch/kernel_ab.py over ``base`` and one name per family M1-M9,
   and K7, the harness over ``bd`` and ``bd_lmxu``, at (8, 1370, 16 x 64)
   bf16, each variant held against its plain version in fp32 at the bf16
   gates, the elementwise atol scaled by max(1, max |ref|) for the
   unnormalised families (relative RMS alone for ``noexp``, ~1e31); the
   harness run is the path whose launches are counted. Before them, head
   dim 8 of K3 and K4 in bf16 and fp32. ``library_ms`` is one PyTorch call
   computing the same
   function on the same data, timed as a yardstick and never called by the
   port: ``F.scaled_dot_product_attention`` for K1, K3, K4, K6 (M1) and K7,
   ``F.conv2d`` (cuDNN, channels-last bf16, on the padded input) for K5.
   ``bound_ms`` is the larger of the bytes moved over 3.35 TB/s and the
   operations over 989 TFLOP/s (bf16 dense, H100 SXM).
4. Builds UniDepthV2 ViT-L/14 from configs/config_v2_vitl14.json with
   random weights (``init_params(seed=0)``), runs ``infer()`` on 8 seeded
   518x518 images in bf16, checks shapes, finiteness and depth > 0, checks
   that the forward launched K1 (flash_attention_qkv) 24 times, K2
   (ln_dense) 24 times, K3 (flash_attention) 4 times and K4 never, and
   holds depth against the same model run on the plain path in fp32 on the
   card (median relative error <= 1e-2). Then times depth-only ``infer()``
   in three rounds and prints each.
5. The int8 serving path on the same model: ``set_serving_precision('int8')``
   quantizes the encoder from the fp32 masters that ``init_params`` kept,
   then ``infer()`` on the same images: shapes, finiteness and depth > 0;
   launches K4 (flash_attention_packed) 24, K1 0, K2 0, K3 4; depth against
   the fp32 plain path at the JAX package's int8 bounds (mean relative
   error < 0.05, 99th percentile < 0.15, intrinsics relative error < 0.1,
   tests/test_quant.py). Then one forward under the stage mask (True, False,
   True, False): launches K4 12, K1 12, K2 12, K3 4. Then times int8
   depth-only ``infer()`` in three rounds.

Each path's launch counts are set to 0 just before it runs and read just
after. The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Any failing phase raises.
"""

import importlib.util
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "config_v2_vitl14.json"
BATCH, SIDE, SEED = 8, 518, 0
TOL_BF16 = dict(rtol=1.6e-2, atol=1e-2)
REL_RMS_BF16 = 5e-3
STAGE_MASK = (True, False, True, False)
HBM_BYTES_S, BF16_FLOP_S = 3.35e12, 989e12  # H100 SXM, dense
AB_SHAPE = dict(b=BATCH, heads=16, n=1370, d=64)
AB_ITERS = 20
# base (K4) and one name per K6 family M1-M9; then K7
AB_FAMILY_NAMES = ("base", "tr_max", "bf16p", "nomax_guard", "tr_lmxu", "nomax", "noexp", "gemmonly",
                   "qk_only", "pv_only")
BD_NAMES = ("bd", "bd_lmxu")


def log(*args):
    print(*args, flush=True)


def time_ms(fn, iters=10, reps=10, warmup=3):
    """Median milliseconds per call of ``fn()``: CUDA events around ``reps``
    back-to-back calls (so the wrapper's host time overlaps the kernel
    before it), the median of ``iters`` such runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def check_close(name, out, ref, **tol):
    err = (out.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), **tol, msg=lambda m: f"{name}: {m}")
    return err


def bound(flops, nbytes):
    """The least time the card could take: bytes over HBM bandwidth or bf16
    operations over the dense tensor-core peak, whichever is larger."""
    t_ops, t_bytes = flops / BF16_FLOP_S * 1e3, nbytes / HBM_BYTES_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if torch.is_tensor(t))


def check_bf16(name, out, ref):
    """The bf16 gates: elementwise (output rounding) and relative RMS."""
    err = check_close(f"{name} bf16", out, ref, **TOL_BF16)
    rel_rms = ((out.float() - ref).norm() / ref.norm()).item()
    if not rel_rms <= REL_RMS_BF16:
        raise RuntimeError(f"{name} bf16: relative RMS error {rel_rms:.3e} > {REL_RMS_BF16}")
    return err, rel_rms


def kernel_phase(name, kernel, plain, make_inputs, fp32_tol, flops, library=None):
    """Compare ``kernel`` with ``plain`` in bf16 and fp32 I/O; time both in
    bf16, and ``library(*args)()``, a yardstick call on the same data."""
    args = make_inputs(torch.bfloat16)
    out = kernel(*args)
    torch.cuda.synchronize()
    ref = plain(*[a.float() if torch.is_tensor(a) else a for a in args])
    err, rel_rms = check_bf16(name, out, ref)
    args32 = make_inputs(torch.float32)
    err32 = check_close(f"{name} fp32", kernel(*args32), plain(*args32), rtol=fp32_tol, atol=fp32_tol)
    del args32
    ms = time_ms(lambda: kernel(*args))
    plain_ms = time_ms(lambda: plain(*args))
    library_ms = time_ms(library(*args)) if library else None
    lib = f", library {library_ms:.4f} ms" if library else ""
    log(f"{name}: bf16 max_abs_err {err:.3e} rel_rms {rel_rms:.3e}, fp32 max_abs_err {err32:.3e}; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib} (bf16)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            **bound(flops, nbytes(*args, out))}


def sdpa(q, k, v, scale):
    """One F.scaled_dot_product_attention call on (..., N, D) views: the
    library yardstick of the attention kernels."""
    return lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)


def heads_view(x, num_heads):
    b, n, c = x.shape
    return x.view(b, n, num_heads, c // num_heads).transpose(1, 2)


def load_harness():
    """scripts_torch/kernel_ab.py, the A/B harness of K6 and K7."""
    spec = importlib.util.spec_from_file_location("kernel_ab_harness", ROOT / "scripts_torch" / "kernel_ab.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_path(name, kernels, call):
    """Set every kernel's count to 0, run ``call()`` and return its output
    with the counts it left."""
    for fn in kernels.values():
        fn.launches = 0
    out = call()
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernels.items()}
    log(f"launches in one {name}: {launches}")
    return out, launches


def check_launches(name, launches, expected):
    if launches != expected:
        raise RuntimeError(f"{name}: kernel launches {launches} != expected {expected}")


def check_outputs(name, out):
    shapes = {"depth": 1, "points": 3, "rays": 3, "confidence": 1, "radius": 1}
    for key, ch in shapes.items():
        if tuple(out[key].shape) != (BATCH, SIDE, SIDE, ch):
            raise RuntimeError(f"{name}: {key} has shape {tuple(out[key].shape)}")
        if not torch.isfinite(out[key]).all():
            raise RuntimeError(f"{name}: {key} is not finite")
    if tuple(out["intrinsics"].shape) != (BATCH, 3, 3) or not torch.isfinite(out["intrinsics"]).all():
        raise RuntimeError(f"{name}: intrinsics malformed")
    if not (out["depth"] > 0).all():
        raise RuntimeError(f"{name}: depth is not positive everywhere")


def images_per_s(name, model, rgb, smi, iters=5):
    """Depth-only ``infer()`` in three timed rounds; returns the median rate."""
    rounds = []
    for _ in range(2):
        model.infer(rgb, outputs=("depth",))
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            model.infer(rgb, outputs=("depth",))
        torch.cuda.synchronize()
        rounds.append(BATCH * iters / (time.perf_counter() - t0))
    rate = statistics.median(rounds)
    log(f"infer depth-only B={BATCH} {SIDE}x{SIDE} {name}: {BATCH / rate * 1e3:.2f} ms/batch, "
        f"{rate:.2f} images/s, median of rounds {', '.join(f'{r:.2f}' for r in rounds)} ({smi})")
    return rate


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this test has no CPU path")
    if not CONFIG.is_file():
        raise SystemExit(f"chip_smoke: {CONFIG} not found; run from the root of a checkout")
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2
    from unidepth_tpu_torch.ops import _cuda
    from unidepth_tpu_torch.ops.conv_kernels import conv3x3_lowchannel, conv3x3_lowchannel_plain
    from unidepth_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_packed,
        flash_attention_packed_plain,
        flash_attention_plain,
        flash_attention_qkv,
        flash_attention_qkv_plain,
    )
    from unidepth_tpu_torch.ops.fused_block import ln_dense, ln_dense_plain
    from unidepth_tpu_torch.ops.kernel_ab import run_bd, run_variant, run_variant_plain

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # --- build -------------------------------------------------------------
    t0 = time.perf_counter()
    _cuda.library()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {_cuda.build_seconds} s)")

    # every kernel's wrapper, by the name its record carries
    kernels = {
        "flash_attention_qkv": flash_attention_qkv,
        "ln_dense": ln_dense,
        "flash_attention": flash_attention,
        "flash_attention_packed": flash_attention_packed,
        "conv3x3_lowchannel": conv3x3_lowchannel,
        "run_variant": run_variant,
        "run_bd": run_bd,
    }
    none = dict.fromkeys(kernels, 0)

    # --- kernels at the main path's shapes -----------------------------------
    gen = torch.Generator(device=dev)

    def randn(*shape, dtype, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * std + mean).to(dtype)

    def k1_inputs(dtype):
        gen.manual_seed(1)
        return randn(BATCH, 1370, 3 * 1024, dtype=dtype), 16, 64**-0.5

    def k2_inputs(dtype):
        gen.manual_seed(2)
        c, f = 1024, 4096
        return (
            randn(BATCH * 1370, c, dtype=dtype, std=2.0, mean=0.5),
            randn(f, c, dtype=dtype, std=c**-0.5),
            randn(f, dtype=dtype, std=0.1),
            randn(c, dtype=dtype, std=0.1, mean=1.0),
            randn(c, dtype=dtype, std=0.1),
            1e-6,
            "gelu",
        )

    def k3_inputs(dtype):
        gen.manual_seed(3)
        return tuple(randn(BATCH * 8, 1369, 64, dtype=dtype) for _ in range(3)) + (64**-0.5,)

    def k4_inputs(dtype):
        # the int8 block's call: the three channel slices of its qkv output,
        # read in place (row stride 3C, batch stride N * 3C)
        gen.manual_seed(4)
        return (*randn(BATCH, 1370, 3 * 1024, dtype=dtype).split(1024, dim=-1), 16, 64**-0.5)

    def k5_inputs(dtype, shape=(BATCH, SIDE, SIDE, 64, 32), mode="reflect"):
        # the V2 heads' hr conv (to_depth_hr1 / to_conf_hr1): NHWC, 64 -> 32
        gen.manual_seed(5)
        b, h, w, cin, cout = shape
        return (randn(b, h, w, cin, dtype=dtype), randn(3, 3, cin, cout, dtype=dtype, std=(9 * cin) ** -0.5),
                randn(cout, dtype=dtype, std=0.1), mode)

    def attention_flops(q, k, num_heads):
        b, nq, c = q.shape
        return 4 * b * nq * k.shape[1] * c

    def sdpa_qkv(qkv, num_heads, scale):
        return sdpa(*(heads_view(t, num_heads) for t in qkv.chunk(3, dim=-1)), scale)

    def sdpa_packed(q, k, v, num_heads, scale):
        return sdpa(*(heads_view(t, num_heads) for t in (q, k, v)), scale)

    def conv_library(x, w, bias, mode):
        # cuDNN on the padded input in channels-last bf16: the same output
        pad = "constant" if mode == "zeros" else mode
        xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode=pad).contiguous(memory_format=torch.channels_last)
        wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        return lambda: F.conv2d(xp, wl, bias)

    m = {}
    m["flash_attention_qkv"] = kernel_phase(
        "K1 flash_attention_qkv", flash_attention_qkv, flash_attention_qkv_plain, k1_inputs, 1e-4,
        4 * BATCH * 1370 * 1370 * 1024, sdpa_qkv)
    m["ln_dense"] = kernel_phase("K2 ln_dense", ln_dense, ln_dense_plain, k2_inputs, 2e-4,
                                 2 * BATCH * 1370 * 1024 * 4096)
    m["flash_attention"] = kernel_phase(
        "K3 flash_attention", flash_attention, flash_attention_plain, k3_inputs, 1e-4,
        4 * BATCH * 8 * 1369 * 1369 * 64, lambda q, k, v, scale: sdpa(q[None], k[None], v[None], scale))
    m["flash_attention_packed"] = kernel_phase(
        "K4 flash_attention_packed", flash_attention_packed, flash_attention_packed_plain, k4_inputs, 1e-4,
        4 * BATCH * 1370 * 1370 * 1024, sdpa_packed)

    # head dim 8: the K3 and K4 instantiation that zero-fills the mma k step
    for dtype in (torch.bfloat16, torch.float32):
        gen.manual_seed(8)
        q, k, v = randn(BATCH, 1370, 3 * 128, dtype=dtype).split(128, dim=-1)
        qh, kh, vh = (randn(16, 300, 8, dtype=dtype) for _ in range(3))
        for name, out, ref in (
            ("K4 d=8", flash_attention_packed(q, k, v, 16), flash_attention_packed_plain(q.float(), k.float(), v.float(), 16, 8**-0.5)),
            ("K3 d=8", flash_attention(qh, kh, vh, 8**-0.5), flash_attention_plain(qh.float(), kh.float(), vh.float(), 8**-0.5)),
        ):
            if dtype == torch.bfloat16:
                err, rel = check_bf16(name, out, ref)
                log(f"{name} bf16: max_abs_err {err:.3e} rel_rms {rel:.3e}")
            else:
                log(f"{name} fp32: max_abs_err {check_close(name + ' fp32', out, ref, rtol=1e-4, atol=1e-4):.3e}")

    # --- K5: conv3x3_lowchannel, its entry point the op itself ---------------
    b, h, w, cin, cout = BATCH, SIDE, SIDE, 64, 32
    m["conv3x3_lowchannel"] = kernel_phase(
        "K5 conv3x3_lowchannel (8, 518, 518, 64->32) reflect", conv3x3_lowchannel, conv3x3_lowchannel_plain,
        k5_inputs, 1e-4, 2 * b * h * w * 9 * cin * cout, conv_library)
    for shape, mode in (((2, 37, 45, 64, 32), "zeros"), ((2, 37, 45, 64, 32), "replicate"),
                        ((2, 21, 37, 16, 8), "reflect"), ((1, 10, 40, 32, 16), "zeros"), ((1, 9, 13, 8, 4), "replicate")):
        for dtype in (torch.bfloat16, torch.float32):
            args = k5_inputs(dtype, shape, mode)
            out = conv3x3_lowchannel(*args)
            ref = conv3x3_lowchannel_plain(*[a.float() if torch.is_tensor(a) else a for a in args])
            name = f"K5 {shape} {mode}"
            if dtype == torch.bfloat16:
                err, rel = check_bf16(name, out, ref)
                log(f"{name} bf16: max_abs_err {err:.3e} rel_rms {rel:.3e}")
            else:
                log(f"{name} fp32: max_abs_err {check_close(name + ' fp32', out, ref, rtol=1e-4, atol=1e-4):.3e}")
    k5_args = k5_inputs(torch.bfloat16)
    _, k5_launches = run_path("K5 conv3x3_lowchannel call", kernels, lambda: conv3x3_lowchannel(*k5_args))
    check_launches("K5 conv3x3_lowchannel call", k5_launches, {**none, "conv3x3_lowchannel": 1})
    del k5_args

    # --- K6 and K7: the A/B harness (scripts_torch/kernel_ab.py) -------------
    harness = load_harness()
    calls = 2 + 3 * AB_ITERS  # each variant: the checked call, the warm-up, 3 timed runs
    rows6, k6_launches = run_path(
        "K6 kernel_ab harness", kernels,
        lambda: harness.run(AB_FAMILY_NAMES, iters=AB_ITERS, check=True, log=log, **AB_SHAPE))
    check_launches("K6 kernel_ab harness", k6_launches,
                   {**none, "run_variant": calls * (len(AB_FAMILY_NAMES) - 1), "flash_attention_packed": calls})
    rows7, k7_launches = run_path(
        "K7 kernel_ab harness", kernels,
        lambda: harness.run(BD_NAMES, iters=AB_ITERS, check=True, log=log, **AB_SHAPE))
    check_launches("K7 kernel_ab harness", k7_launches, {**none, "run_bd": calls * len(BD_NAMES)})
    q, k, v = harness.make_inputs(**AB_SHAPE)
    nh, scale = AB_SHAPE["heads"], AB_SHAPE["d"] ** -0.5
    ab_library_ms = time_ms(sdpa_packed(q, k, v, nh, scale))
    ab_bound = bound(attention_flops(q, k, nh), nbytes(q, k, v, q))
    for key, rows, first, plain_name in (("run_variant", rows6, "tr_max", "tr_max"), ("run_bd", rows7, "bd", "bd")):
        row = next(r for r in rows if r["variant"] == first)
        plain_ms = time_ms(lambda: run_variant_plain(plain_name, q, k, v, nh, scale), iters=3, reps=3)
        m[key] = {"max_abs_err": row["plain_max_abs_err"], "ms": row["ms"], "plain_ms": plain_ms,
                  "library_ms": ab_library_ms, **ab_bound,
                  "variants_ms": {r["variant"]: r["ms"] for r in rows}}
        log(f"{key}: {first} {row['ms']:.4f} ms, plain {plain_ms:.4f} ms, library (SDPA) {ab_library_ms:.4f} ms")
    del q, k, v

    # --- the main path: ViT-L/14 infer() at B=8, 518x518 ----------------------
    warnings.simplefilter("ignore")  # resolution_level unset: default budget
    config = json.loads(CONFIG.read_text())
    t0 = time.perf_counter()
    model = UniDepthV2.from_config(config, device=dev).init_params(seed=SEED).eval()
    log(f"model: ViT-L/14 {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, "
        f"{next(model.parameters()).dtype}, built in {time.perf_counter() - t0:.1f} s")
    rgb = np.random.default_rng(SEED).integers(0, 256, (BATCH, SIDE, SIDE, 3), dtype=np.uint8)

    out, launches = run_path("bf16 infer()", kernels, lambda: model.infer(rgb))
    check_launches("bf16 infer()", launches, {**none, "flash_attention_qkv": 24, "ln_dense": 24, "flash_attention": 4})
    check_outputs("bf16 infer()", out)

    ref_model = UniDepthV2.from_config(config, device=dev, dtype=torch.float32).init_params(seed=SEED)
    ref_model.set_kernels(False).eval()
    ref, ref_launches = run_path("fp32 plain infer()", kernels, lambda: ref_model.infer(rgb, outputs=("depth", "intrinsics")))
    if any(ref_launches.values()):
        raise RuntimeError("the plain reference run launched a kernel")
    del ref_model
    rel = ((out["depth"] - ref["depth"]).abs() / ref["depth"].abs()).flatten()
    med, mx = rel.median().item(), rel.max().item()
    log(f"depth vs fp32 plain path: median rel err {med:.3e}, max rel err {mx:.3e}")
    if not med <= 1e-2:
        raise RuntimeError(f"depth median relative error {med} > 1e-2")
    del out
    images_per_s("bf16", model, rgb, smi)

    # --- the int8 serving path: same weights, encoder GEMMs in int8 -----------
    model.set_serving_precision("int8")
    t0 = time.perf_counter()
    model._serving_encoder()
    torch.cuda.synchronize()
    log(f"int8 encoder quantized from the fp32 masters in {time.perf_counter() - t0:.2f} s")
    out_q, launches_q = run_path("int8 infer()", kernels, lambda: model.infer(rgb))
    check_launches("int8 infer()", launches_q, {**none, "flash_attention": 4, "flash_attention_packed": 24})
    check_outputs("int8 infer()", out_q)
    # the JAX package's int8 bounds against full precision (tests/test_quant.py)
    rel = ((out_q["depth"] - ref["depth"]).abs() / (ref["depth"].abs() + 1e-6)).flatten()
    mean, p99 = rel.mean().item(), torch.quantile(rel, 0.99).item()
    k_rel = ((out_q["intrinsics"] - ref["intrinsics"]).abs() / (ref["intrinsics"].abs() + 1e-6)).max().item()
    log(f"int8 depth vs fp32 plain path: mean rel err {mean:.3e}, p99 {p99:.3e}, max {rel.max().item():.3e}; "
        f"intrinsics max rel err {k_rel:.3e}")
    if not (mean < 0.05 and p99 < 0.15 and k_rel < 0.1):
        raise RuntimeError(f"int8 drift out of bounds: mean {mean}, p99 {p99}, intrinsics {k_rel}")
    del out_q

    model._int8_stages = STAGE_MASK
    out_m, launches_m = run_path(f"int8 infer() under stage mask {STAGE_MASK}", kernels, lambda: model.infer(rgb))
    check_launches("masked int8 infer()", launches_m,
                   {**none, "flash_attention_qkv": 12, "ln_dense": 12, "flash_attention": 4, "flash_attention_packed": 12})
    check_outputs("masked int8 infer()", out_m)
    del out_m
    model._int8_stages = None
    images_per_s("int8", model, rgb, smi)

    # each kernel's count from the path it serves: K1-K3 the bf16 path, K4 the
    # int8 one, K5 its own call, K6 and K7 the harness
    path_launches = {
        **launches,
        "flash_attention_packed": launches_q["flash_attention_packed"],
        "conv3x3_lowchannel": k5_launches["conv3x3_lowchannel"],
        "run_variant": k6_launches["run_variant"],
        "run_bd": k7_launches["run_bd"],
    }
    sources = {
        "flash_attention_qkv": ("attention.cu", "unidepth_tpu/ops/flash_attention.py:471"),
        "ln_dense": ("ln_dense.cu", "unidepth_tpu/ops/fused_block.py:102"),
        "flash_attention": ("attention.cu", "unidepth_tpu/ops/flash_attention.py:159"),
        "flash_attention_packed": ("attention.cu", "unidepth_tpu/ops/flash_attention.py:347"),
        "conv3x3_lowchannel": ("conv3x3.cu", "unidepth_tpu/ops/conv_kernels.py:88"),
        "run_variant": ("attention_ab.cu", "scripts/kernel_ab.py:53"),
        "run_bd": ("attention_ab.cu", "scripts/kernel_ab.py:214"),
    }
    record = [
        {"name": name, "route": "cuda", "source": f"unidepth_tpu_torch/csrc/{src}", "replaces": rep,
         "launches": path_launches[name], **m[name]}
        for name, (src, rep) in sources.items()
    ]
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s, the build included")
    log(json.dumps({"kernels": record}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
