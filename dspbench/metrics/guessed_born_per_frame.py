"""guessed_born_per_frame: the GUESSED_BORN particles that template
birth's insert accepted a frame (the program's ``guessed_born_count``
counter), mean over the window's frames outside the profiled slice; None
where the program has no such counter or ran no template matching."""

from dspbench.program_trace import _counter


def read(run):
    from semantic_dsp_map_tpu_torch import timing

    if run.program is None or "guessed_born_count" not in getattr(timing, "COUNTERS", ()):
        return None
    return _counter(("guessed_born_count",))(run, run.program)
