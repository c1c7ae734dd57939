"""Window arithmetic: rates over the whole window, percentiles over every
unit of it. No statistic is taken from medians of chunks."""

from __future__ import annotations

import math


def rate(amount: float, window_s: float) -> float:
    """Work completed in the window divided by the window's wall time."""
    if window_s <= 0:
        raise ValueError("the window has no length")
    return amount / window_s


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of every value, interpolated linearly
    between the two nearest ranks (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def mean(values) -> float:
    xs = list(values)
    return sum(xs) / len(xs)
