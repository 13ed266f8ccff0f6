"""overflow_per_frame: the program's six overflow counters (the five
``*_overflow`` and ``table_dropped``) a frame, summed, mean over the
window's frames outside the profiled slice."""

from dspbench.program_trace import read as read_program


def read(run):
    return read_program("overflow_per_frame", run)
