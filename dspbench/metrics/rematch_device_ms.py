"""rematch_device_ms: device ms a frame of template rematch (the gate over
the object table, the rematch slots, their delete pass and insert), from
the program's ``rematch_start`` and ``rematch_end`` stamps, mean over the
window's frames outside the profiled slice; None where the program has no
such stage or ran no template matching."""

from dspbench.program_trace import _stage


def read(run):
    from semantic_dsp_map_tpu_torch import timing

    if run.program is None or "rematch" not in timing.STAGES:
        return None
    return _stage("rematch")(run, run.program)
