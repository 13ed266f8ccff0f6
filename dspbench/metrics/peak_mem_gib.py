"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over the run up to
the window's close, in GiB (the harness's own counts of the store kept
out)."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
