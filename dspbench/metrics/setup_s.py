"""setup_s: the process's start to the window's first frame: imports, the
kernel library (built on a checkout's first run), the ring, the map, the
set-up frames (eager, captured, replayed) and the output check's copy of
their state."""


def read(run):
    return run.setup_s
