"""Readings of the correctness numbers over many seeds in one process:
the program's (lower readings), its control's, or the program's with a
planted fault (upper readings).

    python -m qem_bench.readings --workload <cell> --mode \\
        program|control|<fault> --calls <n> --seeds <s> [<s> ...]

Each seed makes ``--calls`` calls at the cell's own sizes (no window) and
prints one JSON line of the numbers its check compares.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", default="program")
    ap.add_argument("--calls", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import importlib

    from . import faults, spec
    from .run import run_cell

    bench = spec.benchmark(os.getcwd())
    cell = spec.cell(bench, args.workload)
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    entry_cls = (importlib.import_module(
        f"qem_bench.entries.{traffic['entry']}").Control
        if args.mode == "control" else None)

    def planted():
        return (faults.plant(args.mode) if args.mode in faults.FAULTS
                else contextlib.nullcontext())

    for seed in args.seeds:
        t0 = time.perf_counter()
        with planted():
            res = run_cell(args.workload, cfg, traffic,
                           spec.limits(args.workload), [], [], seed, 0.0,
                           False, args.device, spec.reader,
                           lambda: 0.0, stop=lambda i, el: i < args.calls,
                           entry_cls=entry_cls, warm=False)
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "correct": res["correct"],
                          "numbers": {k: c["value"] for k, c in
                                      res["checks"].items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
