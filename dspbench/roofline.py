"""A kernel's share of its roofline in a traced slice."""

from __future__ import annotations

from .trace import hand_written


def share(run, kernels: tuple, bound_key: str):
    """100 x bound / device time a launch of the kernels named, or None
    where the slice ran none of them or no census was taken."""
    s = run.slice
    if s is None or len(run.census) < 2:
        return None
    lo, hi = s.window
    us = [e.dur_us for e in s.kernels() if lo <= e.start_us <= hi and hand_written(e.name) in kernels]
    if not us:
        return None
    bound = sum(c[bound_key] for c in run.census) / len(run.census)
    return 100.0 * bound / (sum(us) / len(us) / 1e3)
