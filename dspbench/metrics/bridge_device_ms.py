"""bridge_device_ms: device ms a frame from graph "fit"'s end to graph
"finish"'s start (the refit's SVD and the device's wait while the host
reads its flags), from the program's stamps, mean over the window's
frames outside the profiled slice; None where the step is one graph."""

from dspbench.program_trace import read as read_program


def read(run):
    return read_program("bridge_device_ms", run)
