"""pack_span_ms: ms a frame in the program's ``dsp.pack`` span
(``frontend.PackedFrame.pack``: the frame packed into the buffer the map
holds), mean over the window's frames outside the profiled slice."""

from dspbench.program_trace import read as read_program


def read(run):
    return read_program("pack_span_ms", run)
