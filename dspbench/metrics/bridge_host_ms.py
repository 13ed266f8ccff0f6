"""bridge_host_ms: host ms a frame in the program's ``dsp.bridge`` span
(the refit's eager SVD between graphs "fit" and "finish"), mean over the
window's frames outside the profiled slice; None where the step is one
graph."""

from dspbench.program_trace import read as read_program


def read(run):
    return read_program("bridge_host_ms", run)
