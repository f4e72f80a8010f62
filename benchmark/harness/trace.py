"""Reduction of a ``torch.profiler`` trace to what the per-layer metrics read.

A traced span holds whole requests: the profiler starts before one and
stops after another, and each request ends in a copy to the host, so the
device is idle at both ends. From its events this module takes

* the device's busy time, the union of every device operation's interval
  (``busy_and_span_us``, a copy of ``scripts_torch/profile_int8.py``'s),
  and the span from the first operation's start to the last one's end;
* the device time of each operation name;
* the idle gaps between the busy intervals, each labelled by what the host
  was doing at its middle: the benchmark's span (``bench.request``,
  ``bench.encoder``, ``bench.decoder``, recorded with ``record_function``
  by the harness) and the outermost operation the host was in there.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

SPANS = ("bench.request", "bench.encoder", "bench.decoder")
STAGE_LABELS = {"bench.encoder": "encoder", "bench.decoder": "decoder", "bench.request": "prepost"}


def busy_and_span_us(intervals):
    """Union of the [start, end) intervals, and the whole span."""
    intervals = sorted(intervals)
    busy, cur_s, cur_e = 0, *intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s, intervals[-1][1] - intervals[0][0]


def gaps(intervals):
    """The (start, end) gaps between the union of the intervals."""
    out = []
    intervals = sorted(intervals)
    cur_e = intervals[0][1]
    for s, e in intervals[1:]:
        if s > cur_e:
            out.append((cur_e, s))
        cur_e = max(cur_e, e)
    return out


class _Cover:
    """Disjoint host intervals with a name each; ``at(t)`` finds the one
    holding time t."""

    def __init__(self, items):
        items = sorted(items)
        self.starts = [s for s, _, _ in items]
        self.items = items

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.items[i][1] >= t:
            return self.items[i][2]
        return None


def label_gaps(gap_list, host_events):
    """Seconds of idle device time by label. ``host_events``: (name, start
    us, end us, depth) of the host's operations on the thread that ran the
    requests, depth 0 being outermost."""
    spans = {name: _Cover([(s, e, name) for n, s, e, _ in host_events if n == name]) for name in SPANS}
    outer = _Cover([(s, e, n) for n, s, e, d in host_events if n not in SPANS and d == 0])
    out = defaultdict(float)
    for s, e in gap_list:
        t = 0.5 * (s + e)
        stage = next((STAGE_LABELS[n] for n in ("bench.encoder", "bench.decoder", "bench.request")
                      if spans[n].at(t)), "between requests")
        op = outer.at(t)
        out[f"{stage}: {op}" if op else stage] += (e - s) * 1e-6
    return dict(out)


def reduce(prof) -> dict:
    """busy_s, span_s, device seconds by operation name and idle seconds by
    label, from a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    events = prof.events()
    # the device copies of the harness's record_function spans are no work
    device = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in SPANS
              and not getattr(e, "is_user_annotation", False)]
    if not device:
        return {"busy_s": 0.0, "span_s": 0.0, "device_ops": {}, "idle": {}}
    intervals = [(e.time_range.start, e.time_range.end) for e in device]
    busy, span = busy_and_span_us(intervals)
    by_name = defaultdict(float)
    for e in device:
        by_name[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
    host = [e for e in events if e.device_type == DeviceType.CPU]
    threads = {e.thread for e in host if e.name == "bench.request"}
    host_events = []
    for e in host:
        if e.thread not in threads:
            continue
        depth, parent = 0, e.cpu_parent
        while parent is not None:
            if parent.name not in SPANS:
                depth += 1
            parent = parent.cpu_parent
        host_events.append((e.name, e.time_range.start, e.time_range.end, depth))
    return {
        "busy_s": busy * 1e-6,
        "span_s": span * 1e-6,
        "device_ops": dict(by_name),
        "idle": label_gaps(gaps(intervals), host_events),
    }
