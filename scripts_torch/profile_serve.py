#!/usr/bin/env python3
"""The port's own spans (``unidepth_tpu_torch/utils/tracing.py``) over a
benchmark cell's traffic, on one CUDA card: the host's time in each layer of
``infer()``, the device operations each layer launches, the host's waits on
the device, and what the host was doing in each of the device's idle gaps.

    python3 scripts_torch/profile_serve.py --workload v2-vitl14.serve-b8-518 --seed 7 [--seconds 10]

Run from the root of a checkout on a machine with a CUDA card. The cell's
program, weights and traffic are built as ``benchmark/run.py`` builds them
(``benchmark/harness/session.py`` ``Session``, warm-up included), and each
request is the benchmark's (``infer``, then depth and intrinsics into pinned
host buffers). Then:

1. the spans' cost: four blocks of ``--seconds`` with tracing off, on
   (``annotate=False``), on, off; images/s of the two kinds;
2. from the spans of the two "on" blocks, per request and span name: the
   host ms (mean over requests of the summed spans), the host self ms (less
   the child spans) and, for the phase spans, the device ms;
3. ``torch.profiler`` with ``annotate=True`` over as long as the
   benchmark's traced span (``TRACE_SECONDS`` and at least one block of the
   mix), reduced by ``reduce``: each device operation put down to the
   ``unidepth.*`` spans of the host operation that launched it, found by its
   correlation and then the ``cpu_parent`` chain, never by time (device
   operations run after their launch); the host's waits on the device under
   ``unidepth.infer``; the device's idle gaps labelled by the innermost span
   and the outermost operation the host was in at their middle.

Beside them, per traced request: ``kernel_ops``, the launches of K1-K5 (and
K2g, K2's gated SwiGLU body, and K2h, the V2 heads' LayerNorm -> Linear
pair) counted by their device operations' names in
the trace, so that a replayed stage graph
(``unidepth_tpu_torch/models/stage_graphs.py``) counts as well; and
``graphs``, the stage graphs' counters: replays, eager calls by reason, the
share of stage calls replayed, and the captures made since the process
started (warm-up included).

Prints one JSON line, and writes it to ``--out`` if given. The four numbers
the benchmark's per-layer metrics of these spans would read are under
``"metrics"``: ``encoder_host_ms`` and ``decoder_host_ms`` (item 2),
``decoder_launches`` and ``host_syncs`` (item 3).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import Counter, defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
PREFIX = "unidepth."
ROOT_SPAN = "unidepth.infer"
#: runtime calls that block the host until the device has drained
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


# ----------------------------------------------------------------------------
# the program's spans (tracing.collect())
# ----------------------------------------------------------------------------
def per_request(spans: list[dict]) -> dict:
    """{span name: {"count", "host_ms", "self_ms", "device_ms"}}: means over
    the requests (the distinct ``request`` ids of root spans named
    ``unidepth.infer``) of each name's count, summed host ms, summed host ms
    less the child spans', and summed device ms (None where not timed)."""
    requests = {s["request"] for s in spans if s["name"] == ROOT_SPAN and s["parent"] is None}
    child_ns = defaultdict(int)
    for s in spans:
        if s["parent"] is not None:
            child_ns[s["parent"]] += s["host_end_ns"] - s["host_start_ns"]
    sums = defaultdict(lambda: {"count": 0, "host_ms": 0.0, "self_ms": 0.0, "device_ms": None})
    for s in spans:
        if s["request"] not in requests:
            continue
        row = sums[s["name"]]
        host = s["host_end_ns"] - s["host_start_ns"]
        row["count"] += 1
        row["host_ms"] += host * 1e-6
        row["self_ms"] += (host - child_ns[s["id"]]) * 1e-6
        if s["device_ms"] is not None:
            row["device_ms"] = (row["device_ms"] or 0.0) + s["device_ms"]
    n = len(requests)
    return {name: {k: (v / n if v is not None else None) for k, v in row.items()} for name, row in sums.items()}


# ----------------------------------------------------------------------------
# a profiler trace of annotated spans
# ----------------------------------------------------------------------------
def _spans_of(e) -> list[str]:
    """The ``unidepth.*`` names on ``e``'s ``cpu_parent`` chain, innermost
    first (``e`` itself included)."""
    out = []
    while e is not None:
        if e.name.startswith(PREFIX):
            out.append(e.name)
        e = e.cpu_parent
    return out


def _outer_op(e):
    """The outermost host operation on ``e``'s chain below the innermost
    span (``e`` itself if no operation encloses it there)."""
    op = None
    while e is not None and not e.name.startswith(PREFIX):
        op, e = e, e.cpu_parent
    return op


def _split(events):
    """Host events, device operations (less the device copies of
    record_function ranges, which are no work), and the runtime calls
    (``cuda*`` / ``cu*`` host events) by correlation id: a device operation
    has its launch's correlation id, and the launch's ``cpu_parent`` chain
    holds the operation and the spans that made it."""
    from torch.autograd import DeviceType

    host = [e for e in events if e.device_type == DeviceType.CPU]
    device = [e for e in events if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    return host, device, {e.id: e for e in host if e.name.startswith("cu")}


def _waits(host, device, runtime) -> list:
    """(operation, what) of each host wait under ``unidepth.infer``: each
    synchronising runtime call, and each copy to or from pageable memory
    whose operation made no such call (the copy itself blocks the host)."""
    found = [(e.cpu_parent, e.name) for e in host if e.name in SYNC_CALLS]
    synced = {id(op) for op, _ in found}
    for e in device:
        launch = runtime.get(e.id)
        if "Pageable" in e.name and launch is not None and id(launch.cpu_parent) not in synced:
            found.append((launch.cpu_parent, e.name))
    return [(op, what) for op, what in found if ROOT_SPAN in _spans_of(op)]


def reduce(events) -> dict:
    """From a finished profile's ``events()`` (CPU and CUDA activities,
    spans annotated): ``requests`` (``unidepth.infer`` spans); ``device_s``
    by innermost span; ``launches``, the device operations (kernels, copies,
    sets) under each span, inclusive; ``waits`` by "span: operation: call";
    ``busy_s`` and ``span_s``; ``idle`` seconds by "span: operation", what
    the host was in at each gap's middle; ``ops``, the device operations by
    "phase: name", the phase the ``unidepth.infer.*`` span they ran under
    (what an encoder launches, its kernels' launches included)."""
    from benchmark.harness.trace import _Cover, busy_and_span_us, gaps

    host, device, runtime = _split(events)
    roots = [e for e in host if e.name == ROOT_SPAN]
    out = {"requests": len(roots), "device_s": defaultdict(float), "launches": Counter(), "waits": Counter(),
           "busy_s": 0.0, "span_s": 0.0, "idle": defaultdict(float), "ops": Counter()}
    for e in device:
        names = _spans_of(runtime.get(e.id))
        out["device_s"][names[0] if names else "outside the spans"] += (e.time_range.end - e.time_range.start) * 1e-6
        out["launches"].update(set(names))
        phase = next((n for n in names if n.startswith(ROOT_SPAN + ".")), names[-1] if names else "outside the spans")
        out["ops"][f"{phase}: {e.name[:100]}"] += 1
    for op, what in _waits(host, device, runtime):
        outer = _outer_op(op)
        out["waits"][": ".join([_spans_of(op)[0]] + ([outer.name] if outer else []) + [what])] += 1
    if device:
        intervals = [(e.time_range.start, e.time_range.end) for e in device]
        busy, span = busy_and_span_us(intervals)
        out["busy_s"], out["span_s"] = busy * 1e-6, span * 1e-6
        threads = {e.thread for e in roots}
        levels = defaultdict(list)  # spans by their depth among spans: disjoint at each depth
        outer = []
        for e in host:
            if e.thread not in threads:
                continue
            if e.name.startswith(PREFIX):
                levels[len(_spans_of(e))].append((e.time_range.start, e.time_range.end, e.name))
            elif _outer_op(e) is e:
                outer.append((e.time_range.start, e.time_range.end, e.name))
        covers = [_Cover(levels[d]) for d in sorted(levels, reverse=True)]
        ops_cover = _Cover(outer)
        for s, e in gaps(intervals):
            t = 0.5 * (s + e)
            label = next((n for n in (c.at(t) for c in covers) if n), "between requests")
            op = ops_cover.at(t)
            out["idle"][f"{label}: {op}" if op else label] += (e - s) * 1e-6
    return {k: dict(v) if isinstance(v, dict) else v for k, v in out.items()}


# ----------------------------------------------------------------------------
# the run
# ----------------------------------------------------------------------------
#: the names of each kernel's device operations (the attention kernels K1,
#: K3 and K4 share theirs: the phase and the serving precision tell them apart)
ATTENTION_OPS = ("attn_fwd_wgmma", "attn_fwd_bf16", "attn_fwd_simt")
KERNEL_OPS = {"K2": ("ln_dense_wgmma", "ln_dense_bf16", "ln_dense_simt"), "K2g": ("ln_swiglu_wgmma",),
              "K2h": ("head_mlp_wgmma",), "K5": ("conv3x3_wgmma", "conv3x3_bf16", "conv3x3_simt")}


def kernel_ops(ops: dict, int8: bool = False) -> dict:
    """Launches of K1-K5, K2g and K2h from a trace's device operations by
    "phase: name" (``reduce``'s ``ops``): attention under the encoder is K1
    (K4 when the encoder serves int8), under the decoder K3."""
    out = dict.fromkeys(("K1", "K2", "K2g", "K2h", "K3", "K4", "K5"), 0.0)
    for key, n in ops.items():
        phase, _, name = key.partition(": ")
        if any(k in name for k in ATTENTION_OPS):
            if phase == ROOT_SPAN + ".encoder":
                out["K4" if int8 else "K1"] += n
            elif phase == ROOT_SPAN + ".decoder":
                out["K3"] += n
        for kernel, names in KERNEL_OPS.items():
            if any(k in name for k in names):
                out[kernel] += n
    return out


def graph_counts() -> dict:
    """The stage graphs' counters: captures, replays, eager calls by reason."""
    from unidepth_tpu_torch.models import stage_graphs

    c = stage_graphs.call
    return {"captures": c.captures, "replays": c.replays, "eager": dict(c.eager)}


def _serve(session, state, seconds: float, min_requests: int = 0) -> tuple[int, float]:
    """Requests of the plan for ``seconds`` (and at least ``min_requests``):
    images served and seconds taken, to the end of the device's work."""
    images, start = 0, time.perf_counter()
    n = 0
    while time.perf_counter() - start < seconds or n < min_requests:
        _, rgb, _ = session.plan.request(state["i"])
        state["i"] += 1
        session._request(rgb)
        images += rgb.shape[0]
        n += 1
    session._sync()
    return images, time.perf_counter() - start


def profile(root: Path, workload: str, seed: int, seconds: float, device="cuda") -> dict:
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from benchmark.harness import session as session_mod
    from unidepth_tpu_torch.utils import tracing

    session = session_mod.Session(root, workload, device)
    session.prepare(seed)
    state = {"i": 0}
    block = len(session.plan.block)

    rates = {"off": [0, 0.0], "on": [0, 0.0]}
    spans = []
    for kind in ("off", "on", "on", "off"):
        if kind == "on":
            tracing.enable()
        images, took = _serve(session, state, seconds)
        tracing.disable()
        rates[kind][0] += images
        rates[kind][1] += took
        if kind == "on":
            kept = tracing.collect()
            if kept["dropped"]:
                raise RuntimeError(f"profile_serve: {kept['dropped']} spans dropped; shorten --seconds")
            spans += kept["spans"]
    images_per_s = {k: n / s for k, (n, s) in rates.items()}
    table = per_request(spans)

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if session.device.type == "cuda" else [])
    tracing.enable(annotate=True)
    graphs_before = graph_counts()
    with torch_profile(activities=activities) as prof:
        _serve(session, state, session_mod.TRACE_SECONDS, block)
    graphs = graph_counts()
    traced = reduce(prof.events())
    tracing.disable()
    tracing.collect()

    n = max(traced["requests"], 1)
    replays = graphs["replays"] - graphs_before["replays"]
    eager = {k: v - graphs_before["eager"].get(k, 0) for k, v in graphs["eager"].items()}
    eager = {k: v for k, v in eager.items() if v}
    stage_calls = replays + sum(eager.values())
    return {
        "workload": workload, "seed": seed, "seconds": seconds,
        "device": torch.cuda.get_device_name(session.device) if session.device.type == "cuda" else "cpu",
        "images_per_s": images_per_s,
        "on_cost": 1.0 - images_per_s["on"] / images_per_s["off"],
        "metrics": {
            "encoder_host_ms": table.get("unidepth.infer.encoder", {}).get("host_ms"),
            "decoder_host_ms": table.get("unidepth.infer.decoder", {}).get("host_ms"),
            "decoder_launches": traced["launches"].get("unidepth.infer.decoder", 0) / n,
            "host_syncs": sum(traced["waits"].values()) / n,
        },
        "kernel_ops": {k: v / n for k, v in
                       kernel_ops(traced["ops"], session.model.serving_precision == "int8").items()},
        "graphs": {"replays": replays / n, "eager": {k: v / n for k, v in eager.items()},
                   "replay_share": replays / stage_calls if stage_calls else 0.0,
                   "captures_since_start": graphs["captures"]},
        "spans": table,
        "traced": {**traced, "launches": {k: v / n for k, v in traced["launches"].items()},
                   "ops": {k: v / n for k, v in sorted(traced["ops"].items(), key=lambda x: -x[1])},
                   "waits": {k: v / n for k, v in traced["waits"].items()},
                   "idle": dict(sorted(traced["idle"].items(), key=lambda x: -x[1])[:20])},
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: torch.cuda.is_available() is False")
    sys.path.insert(0, str(ROOT))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    result = {"nvidia_smi": smi, **profile(ROOT, args.workload, args.seed, args.seconds)}
    line = json.dumps(result)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
