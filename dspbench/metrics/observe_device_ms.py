"""observe_device_ms: device ms a frame of ``observe_and_update``
(visibility and the PHD weight update), from the program's stamps, mean
over the window's frames outside the profiled slice."""

from dspbench.program_trace import read as read_program


def read(run):
    return read_program("observe_device_ms", run)
