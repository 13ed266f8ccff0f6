"""born_per_frame: the program's ``born_count`` counter (particles born) a
frame, mean over the window's frames outside the profiled slice."""

from dspbench.program_trace import read as read_program


def read(run):
    return read_program("born_per_frame", run)
