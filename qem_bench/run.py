"""Runs one cell of ``BENCHMARK.json`` once and prints one JSON line.

    python -m qem_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (the program's import, its kernels loaded or built into the
checkout's ``mlqem_tpu_torch/_build/``, the inputs and the warm-up of the
cell's shapes) runs first. Then calls are made in a closed loop, one after
the other, until ``--seconds`` have passed; the window runs from the start
of the first call to the end of the last. After the window the outputs are
checked against the plain reference (``correct``). With ``--trace 1`` the
first ``trace_calls`` calls of the window are profiled and the per-layer
metrics are read from the trace.

The line's ``device`` names the devices the run used, read from the cards
after the window (``cards.py``), and the peak of the fullest: the entry's
own ranks' peaks where it reports them (``device_peaks()``), else the
harness's. A run that used fewer devices than its cell's ``chips``, or
devices of different kinds, prints no line and exits non-zero.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import tempfile
import time
import traceback
from typing import Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "mlqem_tpu")
_T_IMPORT = time.perf_counter()


def process_age() -> float:
    """Seconds since this process started (Linux), else since this module
    was imported."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class DeviceFault(RuntimeError):
    """The run did not use the devices its cell asks for."""


class Run:
    """What the readers of the metrics see."""

    def __init__(self, config, traffic):
        self.config, self.traffic = config, traffic
        self.latencies: List[float] = []
        self.units = 0.0
        self.window_s = 0.0
        self.setup_s = 0.0
        self.peak_bytes = 0
        self.trace: Optional[dict] = None


def run_cell(cell_name: str, config: dict, traffic: dict, limits: dict,
             e2e: List[dict], per_layer: List[dict], seed: int,
             seconds: float, trace: bool, device: str, reader,
             t_setup0, stop=None, entry_cls=None, warm=True, chips=1,
             cards=None) -> dict:
    """One run of a cell; returns the result line's object. ``stop(i,
    elapsed)`` replaces the window's end (tests, readings); ``entry_cls``
    the program's entry (the control); ``cards`` what reads the devices
    used (``cards.Cards(chips)`` on the card, none on the CPU). Raises
    ``DeviceFault`` where the run used fewer than ``chips`` devices or
    devices of different kinds."""
    import importlib

    import numpy as np
    import torch

    from .cards import Cards

    cuda = torch.device(device).type == "cuda"
    if cards is None and cuda:
        cards = Cards(chips)            # before set-up: its baseline
    entry_mod = importlib.import_module(
        f"qem_bench.entries.{traffic['entry']}")
    run = Run(config, traffic)
    entry = (entry_cls or entry_mod.Entry)(config, traffic, seed, device)
    if warm:
        entry.warm()
    from .trace import Spans, reduce_trace

    spans = Spans(use_events=cuda)
    prof = None
    if trace:
        entry.spans(spans)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts):   # start-up, untimed
            torch.zeros(1, device=device).add_(1)
        prof = torch.profiler.profile(activities=acts)
    if cuda:
        torch.cuda.synchronize()
        for d in range(chips):
            torch.cuda.reset_peak_memory_stats(d)
    outputs, attempted, failed = [], 0, 0
    n_traced = traffic.get("trace_calls", 1) if trace else 0
    run.setup_s = t_setup0()
    t0 = time.perf_counter()
    t_end = t0
    i = 0
    while stop(i, t_end - t0) if stop else (i == 0 or t_end - t0 < seconds):
        inputs = entry.inputs(i)
        if i == 0 and prof is not None:
            prof.start()
            spans.active = True
        ts = time.perf_counter()
        attempted += 1
        try:
            with (spans.range("call") if spans.active
                  else contextlib.nullcontext()):
                units, out = entry.call(inputs)
        except Exception:                       # noqa: BLE001 (counted)
            failed += 1
            traceback.print_exc()
            out = None
        t_end = time.perf_counter()
        if out is not None:
            run.latencies.append(t_end - ts)
            run.units += units
            outputs.append(out)
        i += 1
        if prof is not None and i == n_traced:
            if cuda:
                torch.cuda.synchronize()
            spans.active = False
            prof.stop()
    run.window_s = t_end - t0
    own = [torch.cuda.max_memory_allocated(d) if cuda else 0
           for d in range(chips)]
    try:
        if prof is not None:
            if i < n_traced:
                spans.active = False
                prof.stop()
            path = os.path.join(tempfile.gettempdir(),
                                f"qem_bench_trace_{cell_name}.json")
            prof.export_chrome_trace(path)
            try:
                run.trace = reduce_trace(path)
            finally:
                os.remove(path)
            if cuda and not run.trace["kernels"]:
                # no device activity in the profile: CUDA events instead
                run.trace["device_s"] = spans.event_seconds()
            run.trace["work"] = dict(spans.work)
            spans.restore()
        # the entry's ranks and the cards, while the entry holds its state
        peaks = (entry.device_peaks() if hasattr(entry, "device_peaks")
                 else {})
        run.peak_bytes = max(peaks.values()) if peaks else own[0]
        dev, fault = device_info(cards, chips, own, peaks, run.peak_bytes)
        found = forbidden_modules()
        if found:
            raise SystemExit(f"forbidden modules loaded: {found}")
    finally:
        entry.release()
    if fault:
        raise DeviceFault(fault)
    if cuda:
        torch.cuda.empty_cache()
    rng = np.random.default_rng([int(seed) % 2 ** 63, 99])
    t_check = time.perf_counter()
    numbers = entry.check(outputs, rng) if outputs else {}
    numbers["_check_s"] = time.perf_counter() - t_check
    if len(run.latencies) > 1:
        numbers["_call_s_quartiles"] = [
            min(run.latencies), *statistics.quantiles(run.latencies, n=4),
            max(run.latencies)]
    for k, v in numbers.items():
        if k.startswith("_"):
            print(f"diagnostic {k[1:]} = {v!r}", file=sys.stderr)
    checks = {k: {"value": float(v), "limit": float(limits[k])}
              for k, v in numbers.items() if not k.startswith("_")}
    correct = (bool(outputs) and failed == 0 and set(checks) == set(limits)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    metrics = {}
    for m in (per_layer if trace else e2e):
        v = reader("layer_metrics" if trace else "end_to_end", m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and run.trace and "busy_s" in run.trace:
        result["device"]["busy_s"] = run.trace["busy_s"]
        result["device"]["window_s"] = run.trace["window_s"]
        result["breakdown"] = run.trace["breakdown"]
    result["checks"] = checks
    return result


def device_info(cards, chips: int, own: List[int], peaks: Dict[int, int],
                peak: int):
    """The line's ``device`` and what is wrong with it (None where nothing
    is). ``own``: the harness's peak on each of the ``chips`` devices;
    ``peaks``: the entry's, where it reports them; ``peak``: the fullest
    device's. Without ``cards`` (a CPU run) the platform is the CPU."""
    per = [int(peaks.get(d, own[d])) for d in range(chips)]
    if cards is None:
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0,
                "memory_peak_bytes_per_device": per}, None
    used = sorted(cards.used())
    kinds = sorted({cards.kind(d) for d in used})
    dev = {"platform": "gpu", "kind": kinds[0] if kinds else cards.kind(0),
           "count": len(used), "memory_peak_bytes": int(peak),
           "memory_peak_bytes_per_device": per}
    fault = None
    if len(used) < chips:
        fault = (f"the run used {len(used)} of the {chips} device(s) its "
                 f"cell asks for: it holds memory on device(s) {used} of "
                 f"0-{chips - 1} (read by {cards.source}); a run that uses "
                 f"fewer devices than its cell's chips prints no result")
    elif len(kinds) > 1:
        fault = f"the devices the run used are of different kinds: {kinds}"
    return dev, fault


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.getcwd()
    build = os.path.join(root, "mlqem_tpu_torch", "_build")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(build, "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    from . import spec

    bench = spec.benchmark(root)
    cell = spec.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{found}", file=sys.stderr)
        return 2
    import mlqem_tpu_torch  # noqa: F401  (the system under test)

    try:
        result = run_cell(
            args.workload, spec.config(cell["config"]), spec.traffic(
                cell["traffic"]), spec.limits(args.workload),
            spec.metrics_for(bench, "end_to_end", args.workload),
            spec.metrics_for(bench, "per_layer", args.workload), args.seed,
            args.seconds, bool(args.trace), device="cuda",
            reader=spec.reader, t_setup0=process_age, chips=cell["chips"])
    except DeviceFault as e:
        print(f"{args.workload}: {e}", file=sys.stderr)
        return 4
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
