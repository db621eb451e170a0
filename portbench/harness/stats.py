"""Rates, tails and spreads as the benchmark states them."""
from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default), of every value given."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(work: float, window_s: float) -> float:
    """All the work of the window over all of its time."""
    if window_s <= 0:
        raise ValueError("empty window")
    return work / window_s


def spread(values) -> float:
    """Distance between the first and third quartiles (Python's
    ``statistics.quantiles(n=4)``) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
