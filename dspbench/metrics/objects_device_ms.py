"""objects_device_ms: device ms a frame of the object layer (graph "fit",
and the finishing graph's start to the object layer's end), from the
program's stamps (``timing.Trace.stage_ms``), mean over the window's
frames outside the profiled slice."""

from dspbench.program_trace import read as read_program


def read(run):
    return read_program("objects_device_ms", run)
