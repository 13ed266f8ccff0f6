"""cloud_device_ms: device ms a frame of the labeled point cloud (the
object layer's end to the cloud's), from the program's stamps, mean over
the window's frames outside the profiled slice."""

from dspbench.program_trace import read as read_program


def read(run):
    return read_program("cloud_device_ms", run)
