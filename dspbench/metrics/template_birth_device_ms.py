"""template_birth_device_ms: device ms a frame of template birth (its
slot's sweep, the flags, the guessed particles' draws and insert), from the
program's ``template_birth_start`` and ``template_birth_end`` stamps, mean
over the window's frames outside the profiled slice; None where the program
has no such stage or ran no template matching."""

from dspbench.program_trace import _stage


def read(run):
    from semantic_dsp_map_tpu_torch import timing

    if run.program is None or "template_birth" not in timing.STAGES:
        return None
    return _stage("template_birth")(run, run.program)
