"""One run of one cell: set-up, the measured window, the traced span, the
correctness check and the result line.

Set-up (``setup_s``, from the process's first line to the first timed
request): the kernels are built or loaded (``setup.kernel_build_s`` records
the build apart: a checkout's first run compiles), the program's model is
built on the card, its weights are drawn there from the seed, the traffic's
image pool is drawn, and every camera shape of the mix is served twice.

The window: one caller sends the mix's requests back to back for
``seconds``. A request runs from handing its uint8 batch to the program
until the family's host outputs (depth and intrinsics) are in host memory:
on a card, in pinned buffers the harness keeps per camera and output, as a
server reuses its buffers.
Requests completed inside the window give ``images_per_s`` (their images
over the window's seconds) and ``batch_p95_ms`` (the 95th percentile of all
their latencies). Requests the check samples that are still due when the
window closes are served after it, up to a minute, and do not count.

With ``--trace 1`` the window runs with CUDA events around each request and
around the stages the family names (forward pre- and post-hooks on the
modules ``infer`` calls), and after the window a traced span of whole
requests runs under ``torch.profiler``. The per-layer metrics' readers get
a record::

    {"window_s": float,
     "requests": [{"camera": [H, W], "images": int, "latency_ms": float,
                   "request_ms": float, "encoder_ms": float, "decoder_ms": float}],
     "work": {"HxW": the reference's work for one image (ops.Tally fields)},
     "trace": {"busy_s", "span_s", "device_ops": {name: s}, "idle": {label: s},
               "requests": [{"camera": [H, W], "images": int}]},
     "peaks": harness/peaks.py's entry of the card, or None}

Then the peak memory is read, the program is freed, and the sampled
requests' outputs are held to the reference (``harness/check.py``).
"""

from __future__ import annotations

import sys
import time
import traceback
from functools import partial

import torch

from benchmark.harness import check, device as device_facts, registry, stats, trace as trace_mod, traffic, weights, work
from benchmark.harness.peaks import peaks_of

WARMUP_CALLS = 2  # per camera shape
TRACE_SECONDS = 2.0  # the traced span's least length; it also covers one block of the mix
LATE_LIMIT_S = 60.0  # how long sampled requests may run past the window


class StageClock:
    """CUDA events around each request and each named stage of it, and
    ``record_function`` spans of them while ``spans`` is on."""

    def __init__(self, stages: dict):
        self.spans = False
        self.current: dict = {}
        self.open: dict = {}
        self.handles = []
        for name, module in stages.items():
            self.handles.append(module.register_forward_pre_hook(partial(self._pre, name)))
            self.handles.append(module.register_forward_hook(partial(self._post, name)))

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _pre(self, name, module, args):
        self.current[name] = [self._event(), None]
        if self.spans:
            self.open[name] = torch.profiler.record_function(f"bench.{name}")
            self.open[name].__enter__()

    def _post(self, name, module, args, output):
        self.current[name][1] = self._event()
        if name in self.open:
            self.open.pop(name).__exit__(None, None, None)

    def start_request(self):
        self.current = {"request": [self._event(), None]}
        if self.spans:
            self.open["request"] = torch.profiler.record_function("bench.request")
            self.open["request"].__enter__()

    def end_request(self) -> dict:
        self.current["request"][1] = self._event()
        if "request" in self.open:
            self.open.pop("request").__exit__(None, None, None)
        return self.current

    def close(self):
        for h in self.handles:
            h.remove()


def _elapsed_ms(pairs: dict) -> dict:
    return {f"{name}_ms": start.elapsed_time(end) for name, (start, end) in pairs.items()}


class Session:
    """The program of one cell on one device; ``prepare`` draws a seed's
    weights and traffic into it, ``window`` serves them."""

    def __init__(self, root, workload: str, device, fault=None):
        self.cell = registry.cell(root, workload)
        self.device = torch.device(device)
        cfg = self.cell["config_file"]
        self.config = cfg["config"]
        self.dtype = getattr(torch, cfg["dtype"])
        self.assumed = cfg["assumed"]
        self.family = registry.family(cfg["family"])
        self.serve = fault(self.family.serve) if fault else self.family.serve
        self.setup = {}
        t = time.perf_counter()
        if self.device.type == "cuda":
            from unidepth_tpu_torch.ops import _cuda

            _cuda.library()
            self.setup["kernels_built"] = _cuda.build_seconds is not None
            self.setup["kernel_build_s"] = _cuda.build_seconds or 0.0
        self.setup["kernel_load_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.model = self.family.build(self.config, self.device, self.dtype)
        self.entries = weights.spec(self.model, self.assumed["layer_scale"], self.assumed.get("weight_scales"))
        self.setup["model_s"] = time.perf_counter() - t
        self.plan = None
        self._buffers: dict = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prepare(self, seed: int) -> None:
        """Weights, image pool and warm-up for ``seed``."""
        t = time.perf_counter()
        values = weights.draw(self.entries, seed, self.device)
        weights.load(self.model, values)
        del values
        self._sync()
        self.setup["weights_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self._buffers = {}
        self.plan = traffic.Plan(self.cell["traffic_mix"], seed, self.device)
        self.setup["pool_s"] = time.perf_counter() - t
        t = time.perf_counter()
        for pool in self.plan.pool:
            for _ in range(WARMUP_CALLS):
                self._request(pool[0])
        self._sync()
        self.setup["warmup_s"] = time.perf_counter() - t

    def _to_host(self, key, t: torch.Tensor) -> torch.Tensor:
        """``t`` copied into the host buffer for ``key``."""
        if self.device.type != "cuda":
            return t.cpu()
        buf = self._buffers.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = self._buffers[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return buf.copy_(t)

    def _request(self, rgb):
        out = self.serve(self.model, rgb)
        host = {k: self._to_host((tuple(rgb.shape), k), out[k]) for k in self.family.HOST_OUTPUTS}
        return out, host

    def window(self, seconds: float, trace: bool) -> dict:
        """Serve the plan for ``seconds`` (and the sampled requests still due
        after them); with ``trace``, then a traced span."""
        clock = StageClock(self.family.stages(self.model)) if trace else None
        requests, sampled, events = [], [], []
        attempted = failed = 0
        i = 0
        start = time.perf_counter()
        end = start + seconds
        while True:
            now = time.perf_counter()
            if now >= end and (len(sampled) >= self.plan.checked_total or now >= end + LATE_LIMIT_S):
                break
            cam, rgb, checked = self.plan.request(i)
            i += 1
            in_window = now < end
            attempted += in_window
            if clock:
                clock.start_request()
            t0 = time.perf_counter()
            try:
                out, host = self._request(rgb)
            except RuntimeError:
                failed += 1
                traceback.print_exc(file=sys.stderr)
                continue
            t1 = time.perf_counter()
            if clock:
                events.append(clock.end_request())
            if t1 <= end:
                requests.append({"camera": list(self.plan.cameras[cam]), "images": rgb.shape[0],
                                 "latency_ms": (t1 - t0) * 1e3})
            if checked:  # copies of the reused buffers, and the outputs only the check reads
                sampled.append((rgb, {k: host[k].clone() if k in host else out[k].cpu()
                                      for k in self.family.CHECKED_OUTPUTS}))
        record = {"window_s": seconds, "requests": requests, "trace": None}
        if clock:
            self._sync()
            for r, ev in zip(requests, events):
                r.update(_elapsed_ms(ev))
            record["trace"] = self._traced_span(clock, i)
            clock.close()
        return {"record": record, "sampled": sampled, "attempted": attempted, "failed": failed}

    def _traced_span(self, clock: StageClock, i: int) -> dict:
        """Whole requests under the profiler, in two spans of at least
        TRACE_SECONDS and one block of the mix each: the device alone (busy
        time and device operations; recording the host's operations slows
        the host and so lengthens the device's gaps), then host and device
        with the harness's spans (what the host did in each gap)."""
        from torch.profiler import ProfilerActivity, profile

        def serve_span():
            nonlocal i
            done = []
            start = time.perf_counter()
            while time.perf_counter() - start < TRACE_SECONDS or len(done) < len(self.plan.block):
                cam, rgb, _ = self.plan.request(i)
                i += 1
                clock.start_request()
                self._request(rgb)
                clock.end_request()
                done.append({"camera": list(self.plan.cameras[cam]), "images": rgb.shape[0]})
            self._sync()
            return done

        # (a CPU run, as in the tests, has no device activity to record)
        device_only = [ProfilerActivity.CUDA if self.device.type == "cuda" else ProfilerActivity.CPU]
        with profile(activities=device_only) as device_prof:
            traced = serve_span()
        clock.spans = True
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as host_prof:
            serve_span()
        clock.spans = False
        device = trace_mod.reduce(device_prof)
        device["idle"] = trace_mod.reduce(host_prof)["idle"]
        return {**device, "requests": traced}

    def peak_bytes(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0

    def release(self) -> None:
        """Free the program's model and its cached memory."""
        self.model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def numbers(self, seed: int, sampled, fp8: bool = False, condition: bool = True) -> dict:
        """The checked numbers of ``sampled`` (or of the control, ``fp8``);
        ``condition=False``: without ``CONDITION_ON``, for the record."""
        values = weights.served(weights.draw(self.entries, seed, self.device), self.dtype)
        return check.numbers(self.family, self.config, values, sampled, self.device, fp8=fp8, condition=condition)

    def work(self) -> dict:
        """The reference's work for one image of each camera of the mix."""
        shapes = {e.name: e.shape for e in self.entries}
        return {f"{h}x{w}": work.per_image(self.family, self.config, shapes, (h, w)) for h, w in self.plan.cameras}


def run(root, workload: str, seed: int, seconds: float, trace: bool, device, t0: float, fault=None):
    """One run: returns the result object and the lines that set each
    checked number beside its limit."""
    session = Session(root, workload, device, fault=fault)
    session.prepare(seed)
    setup_s = time.perf_counter() - t0
    served = session.window(seconds, trace)
    session._sync()
    peak = session.peak_bytes()
    record = served["record"]
    session.release()

    limits = session.cell["limits"]
    got = session.numbers(seed, served["sampled"])
    checks = {name: {"value": got.get(name, float("inf")), "limit": limit} for name, limit in limits.items()}
    complete = len(served["sampled"]) >= session.plan.checked_total
    correct = complete and served["failed"] == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    lines = [f"check {name}: {c['value']!r} (limit {c['limit']!r})" for name, c in checks.items()]
    lines.append(f"check sampled requests: {len(served['sampled'])} (due {session.plan.checked_total})")
    lines.append(f"check failed requests: {served['failed']} (limit 0)")

    dev = device_facts.facts(session.device, session.cell["chips"], peak)
    result = {"correct": correct, "attempted": served["attempted"], "failed": served["failed"]}
    units = registry.metric_units(root)
    if trace:
        record["work"] = session.work()
        record["peaks"] = peaks_of(dev["kind"])
        metrics = {}
        for name in registry.per_layer(root, workload):
            value = registry.reader(root, name)(record)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
        tr = record["trace"]
        dev.update(busy_s=tr["busy_s"], window_s=tr["span_s"])
        result["metrics"] = metrics
        result["breakdown"] = {
            "device_ops": [[n[:160], s] for n, s in sorted(tr["device_ops"].items(), key=lambda x: -x[1])[:10]],
            "idle_gaps": [[n[:160], s] for n, s in sorted(tr["idle"].items(), key=lambda x: -x[1])[:10]],
        }
    else:
        reqs = record["requests"]
        latencies = [r["latency_ms"] for r in reqs]
        values = {
            "images_per_s": sum(r["images"] for r in reqs) / seconds if reqs else 0.0,
            "batch_p95_ms": stats.percentile(latencies, 95) if reqs else float("inf"),
            "peak_mem_gib": peak / 2**30,
            "setup_s": setup_s,
        }
        result["metrics"] = {name: {"value": values[name], "unit": units[name]}
                             for name in registry.end_to_end(root, workload)}
        # where a run's tail reads far off: a few slow requests, or all of them slower
        result["latency_ms"] = {"requests": len(latencies)}
        if latencies:
            result["latency_ms"].update({f"p{q}": stats.percentile(latencies, q) for q in (5, 50, 95, 99)},
                                        max=max(latencies))
    result["device"] = dev
    result["setup"] = {"setup_s": setup_s, **session.setup}
    result["workload"], result["seed"] = workload, seed
    result["checks"] = checks
    return result, lines
