"""render_roofline_pct: the render kernel's bound over its device time a
launch in the traced slice.  The bound is the bytes the render needs on
the store (``census.render_bytes``: statuses, stamps of the slots with a
status, weight, track and label of the alive ones, the voxels' stamps and
results) at the published 3.35 TB/s, the mean of the counts on the states
the slice's first frame started from and its last frame left."""

from dspbench.roofline import share


def read(run):
    return share(run, ("render_kernel", "render_generic_kernel"), "render_bound_ms")
