"""Tracing / profiling utilities.

Counterpart of ``mlqem_tpu/utils/profiling.py``: a per-stage wall-clock
timer whose report makes data-generation throughput a first-class metric,
and a ``torch.profiler`` trace as a context manager. CUDA launches return
before their work ends, so once CUDA is in use in the process a stage
synchronizes the card as it begins and as it ends: its time is that of
the work it enqueued, to completion.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch


def _sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StageTimer:
    """Accumulating named-stage wall-clock timer."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: {total:.3f}s total, {n} calls, "
                         f"{total / n * 1000:.1f}ms avg")
        return "\n".join(lines)

    def throughput(self, name: str, items: int) -> float:
        """items/sec for a stage."""
        return items / self.totals[name] if self.totals.get(name) else 0.0


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (host ops, and the
    card's kernels where CUDA is available) and write it to
    ``<log_dir>/trace.json`` as a Chrome trace (chrome://tracing,
    Perfetto). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
