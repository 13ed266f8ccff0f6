"""kernels_per_frame: device kernels a frame in the traced slice."""


def read(run):
    s = run.slice
    if s is None:
        return None
    lo, hi = s.window
    n = sum(lo <= e.start_us <= hi for e in s.kernels())
    return n / s.frames if n else None
