"""Statistics of a run and of a set of runs."""

from __future__ import annotations

import statistics


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100) of every value, interpolated between
    the two nearest ranks (``statistics.quantiles``' inclusive method)."""
    values = sorted(values)
    if len(values) == 1:
        return values[0]
    pos = (len(values) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(values) - 1)
    return values[lo] + (values[hi] - values[lo]) * (pos - lo)


def spread(values) -> float:
    """Distance between the first and third quartiles over the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
