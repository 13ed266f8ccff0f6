"""frames_per_s: frames done in the window over the window's seconds (its
start to the last frame's occ on the host), by the host clock."""

from dspbench.stats import rate


def read(run):
    if not run.frames:
        return None
    start, end = run.window
    return rate(sum(not f.failed for f in run.frames), end - start)
