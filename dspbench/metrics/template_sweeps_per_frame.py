"""template_sweeps_per_frame: the template sweeps a frame ran, rematch's
and template birth's summed (the program's ``rematch_sweeps`` and
``template_birth_sweeps`` counters), mean over the window's frames outside
the profiled slice; None where the program has no such counters or ran no
template matching."""

from dspbench.program_trace import _counter

COUNTERS = ("rematch_sweeps", "template_birth_sweeps")


def read(run):
    from semantic_dsp_map_tpu_torch import timing

    if run.program is None or not set(COUNTERS) <= set(getattr(timing, "COUNTERS", ())):
        return None
    return _counter(COUNTERS)(run, run.program)
