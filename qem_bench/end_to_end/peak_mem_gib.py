"""The fullest device's peak allocated bytes over the window, GiB: the
entry's ranks' ``max_memory_allocated()`` where it reports them
(``device_peaks()``), else the harness's own (statistics reset at the
window's start)."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
