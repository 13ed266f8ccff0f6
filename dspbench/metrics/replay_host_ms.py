"""replay_host_ms: host ms a frame in the program's ``dsp.replay.*`` spans
(``fit`` and ``finish``, or ``step``: a graph's ``replay()``, or the
eager body on the frames that run eagerly or capture), mean over the
window's frames outside the profiled slice."""

from dspbench.program_trace import read as read_program


def read(run):
    return read_program("replay_host_ms", run)
