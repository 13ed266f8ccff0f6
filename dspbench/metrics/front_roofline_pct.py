"""front_roofline_pct: the observe candidate scan's bound over its device
time a launch in the traced slice; the bound as ``census.front_bytes``
counts it, on the same two states as render_roofline_pct."""

from dspbench.roofline import share


def read(run):
    return share(run, ("front_kernel", "front_generic_kernel"), "front_bound_ms")
