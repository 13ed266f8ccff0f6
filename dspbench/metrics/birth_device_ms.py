"""birth_device_ms: device ms a frame of birth and resampling (template
birth included), from the program's stamps, mean over the window's
frames outside the profiled slice."""

from dspbench.program_trace import read as read_program


def read(run):
    return read_program("birth_device_ms", run)
