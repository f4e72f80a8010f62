"""The all-requests percentile, the spread, and the reduction of a device
trace to busy time and labelled idle gaps."""

from __future__ import annotations

import random
import statistics

import pytest

from benchmark.harness import stats, trace


def test_percentile_is_over_every_value():
    rng = random.Random(0)
    for n in (1, 2, 19, 200, 461):
        values = [rng.expovariate(1.0) for _ in range(n)]
        want = values[0] if n == 1 else statistics.quantiles(values, n=100, method="inclusive")[94]
        assert stats.percentile(values, 95) == pytest.approx(want)
    # ten slow requests of 200 among 190 fast ones move the 95th percentile
    assert stats.percentile([10.0] * 190 + [50.0] * 10, 95) > 10.0


def test_spread():
    assert stats.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    q1, _, q3 = statistics.quantiles([1, 2, 3, 4, 5, 6], n=4)
    assert stats.spread([1, 2, 3, 4, 5, 6]) == pytest.approx((q3 - q1) / 3.5)


def test_busy_union_and_gaps():
    intervals = [(0, 10), (5, 12), (20, 25), (24, 30), (40, 41)]
    busy, span = trace.busy_and_span_us(intervals)
    assert (busy, span) == (12 + 10 + 1, 41)
    assert trace.gaps(intervals) == [(12, 20), (30, 40)]


def test_idle_gaps_labelled_by_host_span():
    # host: a request 0-100 with its encoder 10-40 and decoder 50-90;
    # an aten op 55-60 inside the decoder; then nothing until the next request
    host = [("bench.request", 0, 100, 0), ("bench.encoder", 10, 40, 0), ("bench.decoder", 50, 90, 0),
            ("aten::copy_", 55, 60, 0), ("aten::add", 56, 57, 1), ("bench.request", 150, 200, 0)]
    gap_list = [(20, 30), (55, 59), (92, 96), (110, 140)]
    out = trace.label_gaps(gap_list, host)
    assert out == pytest.approx({"encoder": 10e-6, "decoder: aten::copy_": 4e-6, "prepost": 4e-6,
                                 "between requests": 30e-6})
