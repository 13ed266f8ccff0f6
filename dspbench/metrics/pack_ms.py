"""pack_ms: ``frontend.pack_frame`` alone on the cell's ring, ms a frame,
timed by the harness after the window over half a second of the host
clock."""


def read(run):
    return run.pack_ms
