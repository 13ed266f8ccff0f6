"""device_idle_pct: the share of the traced slice's steady state (its
second frame's hand-in to its last frame's) in which no kernel, copy or
set ran on the device."""


def read(run):
    s = run.slice
    if s is None or not s.device:
        return None
    lo, hi = s.steady
    return 100.0 * (1.0 - s.busy_us() / (hi - lo))
