"""kernels_per_frame: device kernels a frame in the traced slice, the
program's tracer's stamps (``trace.TRACER_KERNELS``) left out."""


def read(run):
    s = run.slice
    if s is None:
        return None
    lo, hi = s.window
    n = sum(lo <= e.start_us <= hi for e in s.work_kernels())
    return n / s.frames if n else None
