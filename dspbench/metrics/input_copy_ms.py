"""input_copy_ms: ms a frame in the program's ``dsp.input_copy`` span (the
state taken over and the packed frame copied into the step's static
input, ending in a stream synchronize), mean over the window's frames
outside the profiled slice."""

from dspbench.program_trace import read as read_program


def read(run):
    return read_program("input_copy_ms", run)
