"""visible_per_frame: the program's ``visible_count`` counter (particles
observe found visible) a frame, mean over the window's frames outside
the profiled slice."""

from dspbench.program_trace import read as read_program


def read(run):
    return read_program("visible_per_frame", run)
