"""torch_ops_ms_per_frame: device ms a frame, in the traced slice, of every
kernel that is not one of the port's hand-written kernels (the frozen
name list ``trace.HAND_WRITTEN``) nor a stamp of the program's tracer
(``trace.TRACER_KERNELS``): PyTorch's and the libraries' kernels of the
observe, move and birth ops and of the object layer."""

from dspbench.trace import hand_written


def read(run):
    s = run.slice
    if s is None:
        return None
    lo, hi = s.window
    us = [e.dur_us for e in s.work_kernels()
          if lo <= e.start_us <= hi and not hand_written(e.name)]
    return sum(us) / 1e3 / s.frames if us else None
