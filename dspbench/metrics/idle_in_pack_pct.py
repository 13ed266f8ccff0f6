"""idle_in_pack_pct: the share of the profiled slice's steady state in
which the device is idle while the host is inside the program's
``dsp.pack`` range."""

from dspbench.program_trace import read as read_program


def read(run):
    return read_program("idle_in_pack_pct", run)
