"""predict_device_ms: device ms a frame of the prediction (scroll, expiry,
cleanup, rigid moves), from the program's stamps, mean over the window's
frames outside the profiled slice."""

from dspbench.program_trace import read as read_program


def read(run):
    return read_program("predict_device_ms", run)
