"""``torch.cuda.max_memory_allocated()`` over the window (its statistics
reset at the window's start), GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
