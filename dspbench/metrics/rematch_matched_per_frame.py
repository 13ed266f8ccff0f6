"""rematch_matched_per_frame: the rematch slots whose match was good a frame,
the slots for which rematch's delete pass deletes (the program's
``rematch_matched`` counter, a running total read as a frame's share), mean
over the window's frames outside the profiled slice; None where the program
has no such counter or ran no template matching."""

from dspbench.program_trace import _counter


def read(run):
    from semantic_dsp_map_tpu_torch import timing

    if run.program is None or "rematch_matched" not in getattr(timing, "COUNTERS", ()):
        return None
    return _counter(("rematch_matched",))(run, run.program)
