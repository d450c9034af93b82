"""Spans recorded by the benchmark around the program's layers, and the
reduction of a profiler trace to per-span device and host time.

The program records no spans on its public entries, so in a traced run the
benchmark wraps the functions that enter each layer (:class:`Spans`) in
``torch.profiler.record_function`` ranges named ``qb:<name>``. Device time
is the time of the kernels (and copies and fills) that the profiler
correlates to a launch made inside a range; host time is the range's own
length. Where the profiler records no device activity, CUDA events at the
same boundaries give each range's device time.
"""
from __future__ import annotations

import bisect
import collections
import json
from typing import Callable, Dict, List, Optional

import torch

PREFIX = "qb:"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Wraps attributes of objects, classes or modules in named ranges while
    ``active``; ``work(args, kwargs)`` of a span is recorded per call."""

    def __init__(self, use_events: bool):
        self.active = False
        self.use_events = use_events
        self.work: Dict[str, List[dict]] = collections.defaultdict(list)
        self.events: Dict[str, list] = collections.defaultdict(list)
        self._undo: list = []

    def range(self, name: str):
        return _Range(self, name)

    def wrap(self, owner, attr: str, name: str,
             work: Optional[Callable] = None) -> None:
        own = attr in getattr(owner, "__dict__", {})
        orig = owner.__dict__[attr] if own else None
        fn = getattr(owner, attr)

        def wrapped(*args, **kwargs):
            if not self.active:
                return fn(*args, **kwargs)
            if work is not None:
                self.work[name].append(work(args, kwargs))
            with self.range(name):
                return fn(*args, **kwargs)

        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, own, orig))

    def restore(self) -> None:
        for owner, attr, own, orig in reversed(self._undo):
            if own:
                setattr(owner, attr, orig)
            else:
                delattr(owner, attr)
        self._undo.clear()

    def event_seconds(self) -> Dict[str, float]:
        torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in v) / 1e3
                for k, v in self.events.items()}


class _Range:
    def __init__(self, spans: Spans, name: str):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.rf = torch.profiler.record_function(PREFIX + self.name)
        self.rf.__enter__()
        if self.spans.use_events:
            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
            self.ev[0].record()

    def __exit__(self, *exc):
        if self.spans.use_events:
            self.ev[1].record()
            self.spans.events[self.name].append(self.ev)
        self.rf.__exit__(*exc)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_trace(path: str) -> dict:
    """Per-span device seconds, host seconds and counts, the device's busy
    seconds in the traced window (from the first ``qb:call`` range's start
    to the last one's end), and the breakdown: the 10 device operations
    that took most time and the idle time by the innermost span the host
    was in."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launch, device, ranges = {}, [], collections.defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            device.append((float(e["ts"]), float(e.get("dur", 0.0)),
                           e.get("name", "?"),
                           e.get("args", {}).get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = (e["tid"], float(e["ts"]))
        elif cat == "user_annotation" and e.get("name", "").startswith(PREFIX):
            ts = float(e["ts"])
            ranges[e["tid"]].append((ts, ts + float(e.get("dur", 0.0)),
                                     e["name"][len(PREFIX):]))
    host_s, count = collections.Counter(), collections.Counter()
    parent, starts = {}, {}
    for tid, rs in ranges.items():
        rs.sort(key=lambda r: (r[0], -r[1]))
        stack, par = [], []
        for a, b, name in rs:
            host_s[name] += (b - a) / 1e6
            count[name] += 1
            while stack and rs[stack[-1]][1] < a:
                stack.pop()
            par.append(stack[-1] if stack else -1)
            stack.append(len(par) - 1)
        parent[tid], starts[tid] = par, [r[0] for r in rs]

    def enclosing(tid, ts):
        """Names of the ranges on thread ``tid`` open at ``ts``, innermost
        last."""
        rs = ranges.get(tid, [])
        j = bisect.bisect_right(starts.get(tid, []), ts) - 1
        while j >= 0 and rs[j][1] < ts:
            j = parent[tid][j]
        out = []
        while j >= 0:
            out.append(rs[j][2])
            j = parent[tid][j]
        return out[::-1]

    device_s, op_s = collections.Counter(), collections.Counter()
    for ts, dur, name, corr in device:
        op_s[name[:160]] += dur / 1e6
        if corr in launch:
            for n in set(enclosing(*launch[corr])):
                device_s[n] += dur / 1e6
    calls = [(a, b) for rs in ranges.values() for a, b, n in rs
             if n == "call"]
    summary = {"device_s": dict(device_s), "host_s": dict(host_s),
               "count": dict(count), "kernels": bool(device)}
    if not calls:
        return summary
    lo, hi = min(a for a, _ in calls), max(b for _, b in calls)
    busy = _merge([(max(ts, lo), min(ts + dur, hi)) for ts, dur, _, _
                   in device if ts + dur > lo and ts < hi])
    busy_s = sum(b - a for a, b in busy) / 1e6
    main = max(ranges, key=lambda t: sum(n == "call" for _, _, n in
                                         ranges[t]))
    idle = collections.Counter()
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            inner = enclosing(main, (a + b) / 2)
            idle[inner[-1] if inner else "between calls"] += (b - a) / 1e6
    summary.update(
        busy_s=busy_s, window_s=(hi - lo) / 1e6,
        breakdown={"device_ops": [[k, v] for k, v in op_s.most_common(10)],
                   "idle_gaps": [[k, v] for k, v in idle.most_common(10)]})
    return summary
