"""host_api_calls_per_frame: the CUDA runtime and driver calls the
profiler saw in the traced slice, a frame."""


def read(run):
    s = run.slice
    if s is None:
        return None
    lo, hi = s.window
    return sum(lo <= e.start_us <= hi for e in s.api) / s.frames
