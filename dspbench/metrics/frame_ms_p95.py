"""frame_ms_p95: the 95th percentile (nearest rank) over every frame of the
window of the time from handing the frame's host arrays to ``update()``
until its ``occ`` is in host memory, by the host clock.  A failed frame
counts as never done."""

from dspbench.stats import nearest_rank


def read(run):
    if not run.frames:
        return None
    return nearest_rank([float("inf") if f.failed else 1e3 * (f.done - f.handed)
                         for f in run.frames], 0.95)
