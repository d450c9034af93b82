"""Tracing / profiling utilities.

Counterpart of ``mlqem_tpu/utils/profiling.py``: a per-stage wall-clock
timer whose report makes data-generation throughput a first-class metric,
and a ``torch.profiler`` trace as a context manager. CUDA launches return
before their work ends, so once CUDA is in use in the process a stage
synchronizes the card as it begins and as it ends: its time is that of
the work it enqueued, to completion.

The engines mark their stages with :func:`span` (``<module>.<stage>``
names, e.g. ``kicked.generate`` → ``kicked.evolve`` → ``kicked.step``).
A span records only while a ``torch.profiler`` profile runs or inside
:func:`tracing`; otherwise it costs one flag read. Recording, it opens a
``torch.profiler.record_function`` range of its name (so it appears in
the profile, on its clock, with the kernels launched inside it), and adds
its host time and, once CUDA is initialised, the device time between a
CUDA event pair on the current stream to an aggregate kept per *path*:
the names of the open spans from the outermost down, joined by ``/``.
Nothing synchronizes while spans record; :func:`span_totals` reads the
events, synchronizing once. Spans record in the process that runs them:
:func:`fold_spans` adds another process's totals (a rank's) under a
prefix of its own.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler


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


class _SpanTotal:
    """One path's aggregate: closed spans, their host nanoseconds, those
    of their child spans, and the event pairs not yet read."""

    __slots__ = ("count", "host_ns", "child_ns", "device_ms", "pending")

    def __init__(self):
        self.count = self.host_ns = self.child_ns = 0
        self.device_ms: Optional[float] = None
        self.pending: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []


class _Recorder:
    """The process's span aggregates (one per path, in the order each path
    was first opened) and each thread's stack of open spans."""

    def __init__(self):
        self.forced = 0
        self.totals: Dict[str, _SpanTotal] = {}
        self.lock = threading.Lock()
        self.local = threading.local()

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st


_RECORDER = _Recorder()


class _Span:
    __slots__ = ("name", "path", "rf", "events", "t0", "child_ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        stack = _RECORDER.stack()
        self.path = (stack[-1].path + "/" + self.name if stack
                     else self.name)
        with _RECORDER.lock:
            _RECORDER.totals.setdefault(self.path, _SpanTotal())
        self.child_ns = 0
        self.events = None
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        if self.events is not None:
            self.events[1].record()
        stack = _RECORDER.stack()
        stack.pop()
        if stack:
            stack[-1].child_ns += dt
        with _RECORDER.lock:
            tot = _RECORDER.totals.setdefault(self.path, _SpanTotal())
            tot.count += 1
            tot.host_ns += dt
            tot.child_ns += self.child_ns
            if self.events is not None:
                tot.pending.append(self.events)
        self.rf.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records the block as the span ``name``
    under the spans open around it, while a ``torch.profiler`` profile runs
    or inside :func:`tracing`; otherwise a shared no-op context."""
    if not (_RECORDER.forced or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name)


@contextlib.contextmanager
def tracing():
    """Record spans inside the block, with no profiler running."""
    with _RECORDER.lock:
        _RECORDER.forced += 1
    try:
        yield
    finally:
        with _RECORDER.lock:
            _RECORDER.forced -= 1


def span_totals() -> Dict[str, Dict[str, Optional[float]]]:
    """The closed spans' aggregates by path, in the order each path was
    first opened: ``count``, ``host_s``, ``self_host_s`` (host time less
    that of its child spans) and ``device_s`` (the summed time between
    each span's CUDA events; None where no span of the path recorded any).
    Synchronizes the card once if events are pending."""
    with _RECORDER.lock:
        taken = [(t, t.pending) for t in _RECORDER.totals.values()
                 if t.pending]
        for t, _ in taken:
            t.pending = []
    if taken:
        torch.cuda.synchronize()
    read = [(t, sum(a.elapsed_time(b) for a, b in pairs))
            for t, pairs in taken]
    with _RECORDER.lock:
        for t, ms in read:
            t.device_ms = (t.device_ms or 0.0) + ms
        return {path: {"count": t.count, "host_s": t.host_ns / 1e9,
                       "self_host_s": (t.host_ns - t.child_ns) / 1e9,
                       "device_s": (None if t.device_ms is None
                                    else t.device_ms / 1e3)}
                for path, t in _RECORDER.totals.items()}


def fold_spans(totals: Dict[str, Dict[str, Optional[float]]],
               prefix: str) -> None:
    """Add another process's :func:`span_totals` (a rank's, say) to this
    process's aggregates, each path under ``prefix`` (``"mesh.rank1/"``):
    counts, host and self host times and device times add to what the
    path holds already. :func:`reset_spans` drops them with the rest."""
    with _RECORDER.lock:
        for path, t in totals.items():
            tot = _RECORDER.totals.setdefault(prefix + path, _SpanTotal())
            tot.count += int(t["count"])
            tot.host_ns += round(t["host_s"] * 1e9)
            tot.child_ns += round((t["host_s"] - t["self_host_s"]) * 1e9)
            if t["device_s"] is not None:
                tot.device_ms = (tot.device_ms or 0.0) + t["device_s"] * 1e3


def reset_spans() -> None:
    """Drop every span aggregate, folded ones included (spans still open
    are recorded when they close)."""
    with _RECORDER.lock:
        _RECORDER.totals.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (host ops, and the
    card's kernels where CUDA is available) and write it to
    ``<log_dir>/trace.json`` as a Chrome trace (chrome://tracing,
    Perfetto), and the block's span aggregates (:func:`span_totals`,
    which start empty) to ``<log_dir>/spans.json``. Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset_spans()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(span_totals(), f, indent=1)
