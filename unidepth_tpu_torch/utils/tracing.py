"""The port's spans: host time per layer of the serving path, device time per
phase, kept in memory while tracing is on.

    from unidepth_tpu_torch.utils import tracing

    tracing.enable()               # annotate=True: also torch.profiler ranges
    model.infer(rgb)
    spans = tracing.collect()["spans"]   # and the buffer is cleared
    tracing.disable()

Tracing is off by default. Off, ``span(name)`` tests one module flag and
returns one shared no-op object: no allocation, no ``record_function``, no
CUDA event, no clock read. On, each span is kept, when it closes, in a
bounded buffer (``MAX_SPANS``; past it the oldest spans are dropped and
counted). ``collect()`` returns and clears it: a list of records

    {"id", "name", "request", "parent", "host_start_ns", "host_end_ns", "device_ms"}

``request`` is shared by every span of one outermost span (``unidepth.infer``
is the root of a served request), ``parent`` is the enclosing span's ``id``
or None; the host times are ``time.perf_counter_ns``. A span given a CUDA
``device`` (the phase spans) also records a CUDA event pair on that device's
current stream, resolved to ``device_ms`` at ``collect()``; the kernel spans
are host only (``device_ms`` None), as is every span while the stream is
being captured into a CUDA graph, since an event recorded there would be
captured with it.

With ``annotate=True`` each span also opens ``torch.profiler.record_function``
under its name: a profiler trace then holds the span's host interval on the
clock of the device operations, and each device operation can be put down to
the span that launched it (``scripts_torch/profile_serve.py``).

The serving path's spans (V2's and V1's ``infer()``): ``unidepth.infer``
(root) with ``unidepth.infer.{prepare,encoder,decoder,postprocess}``; under
V2's decoder ``unidepth.decoder.{camera,prompt,pyramid,heads}``, under V1's
``unidepth.decoder.{camera,depth}``; the kernel wrappers'
``unidepth.kernel.{K1,K2,K2g,K2h,K3,K4,K5}`` (K2g: K2's gated SwiGLU body;
K2h: the V2 heads' LayerNorm -> Linear pair).
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import torch

__all__ = ["span", "enable", "disable", "collect", "MAX_SPANS"]

MAX_SPANS = 1 << 17  # ~2000 served ViT-L requests of ~60 spans each

_on = False
_annotate = False
_buffer: collections.deque = collections.deque(maxlen=MAX_SPANS)
_dropped = 0
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count()
_requests = itertools.count()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "device", "id", "parent", "request", "start_ns", "end_ns", "events", "range")

    def __init__(self, name: str, device):
        self.name = name
        self.device = device

    def __enter__(self):
        stack = _stack()
        outer = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = outer.id if outer else None
        self.request = outer.request if outer else next(_requests)
        stack.append(self)
        self.events = None
        self.range = None
        if _annotate:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        if self.device is not None and self.device.type == "cuda" and not torch.cuda.is_current_stream_capturing():
            stream = torch.cuda.current_stream(self.device)
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            self.events = (start, stream)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self.events is not None:
            start, stream = self.events
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            self.events = (start, end)
        if self.range is not None:
            self.range.__exit__(*exc)
        _stack().pop()
        _keep(self)
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _keep(s: _Span) -> None:
    global _dropped
    with _lock:
        if len(_buffer) == _buffer.maxlen:
            _dropped += 1
        _buffer.append(s)


def span(name: str, device=None):
    """A context manager timing its body as the span ``name``; with a CUDA
    ``device``, its device time too. Off, the shared no-op ``NO_SPAN``."""
    if not _on:
        return NO_SPAN
    return _Span(name, device)


def enable(annotate: bool = False) -> None:
    """Keep spans from now on; ``annotate``: also as profiler ranges."""
    global _on, _annotate
    _annotate = annotate
    _on = True


def disable() -> None:
    """Stop keeping spans (those kept stay until ``collect``)."""
    global _on, _annotate
    _on = _annotate = False


def collect() -> dict:
    """``{"spans": [record, ...], "dropped": int}``: the spans kept since the
    last call, oldest first, and how many the bound dropped; clears both.
    Waits for the device work of spans that timed it."""
    global _dropped
    with _lock:
        kept, dropped = list(_buffer), _dropped
        _buffer.clear()
        _dropped = 0
    records = []
    for s in kept:
        device_ms = None
        if s.events is not None:
            start, end = s.events
            end.synchronize()
            device_ms = start.elapsed_time(end)
        records.append({"id": s.id, "name": s.name, "request": s.request, "parent": s.parent,
                        "host_start_ns": s.start_ns, "host_end_ns": s.end_ns, "device_ms": device_ms})
    return {"spans": records, "dropped": dropped}
