"""The arithmetic of the end-to-end metrics and of the bounds' spread."""

from __future__ import annotations

import math
import statistics


def nearest_rank(values, q: float) -> float:
    """The ``q`` quantile (0 < q <= 1) of all ``values`` by the nearest-rank
    rule: the smallest value with at least ``q`` of the values at or below
    it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


def rate(count: int, seconds: float) -> float:
    """Work done over the time it took."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return count / seconds


def spread(values) -> float:
    """The distance between the first and third quartile as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
