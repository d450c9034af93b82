"""Tiny versions of the cells for the CPU tests (the same code paths, a few
qubits and calls)."""
from __future__ import annotations

import contextlib
import importlib
import os

import torch

from qem_bench import faults, run, spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = spec.benchmark(ROOT)

TINY = {
    "kicked10q.labels": ({"nq": 4}, {"batch": 512, "check": {
        "ideal_calls": 2, "noisy_circuits": 256, "ref_traj": 1024}}, 3),
    "kicked10q.zne": ({"nq": 4}, {"check": {"noisy_calls": 12,
                                            "ref_traj": 8192}}, 12),
    "lightcone100q.nf1": ({"nq": 12, "steps": 2, "qubits": [0, 5, 11],
                           "t_chunk": 256},
                          {"n_traj": 1024, "check": {
                              "noisy_steps": 2, "noisy_calls": 60,
                              "ref_traj": 8192}}, 60),
}


def tiny_run(cell: str, mode: str = "program", seed: int = 2 ** 31 + 5,
             trace: bool = False):
    """One run of a tiny ``cell`` on the CPU with the cell's own limits:
    the program, its control, or the program with a planted fault."""
    c = spec.cell(BENCH, cell)
    cfg, traffic = spec.config(c["config"]), spec.traffic(c["traffic"])
    over_cfg, over_traffic, calls = TINY[cell]
    cfg.update(over_cfg)
    traffic.update(over_traffic)
    entry_cls = (importlib.import_module(
        f"qem_bench.entries.{traffic['entry']}").Control
        if mode == "control" else None)
    ctx = (faults.plant(mode) if mode in faults.FAULTS
           else contextlib.nullcontext())
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    try:
        with ctx:
            return run.run_cell(
                cell, cfg, traffic, spec.limits(cell),
                spec.metrics_for(BENCH, "end_to_end", cell),
                spec.metrics_for(BENCH, "per_layer", cell), seed, 0.0, trace,
                "cpu", spec.reader, lambda: 0.0,
                stop=lambda i, el: i < calls, entry_cls=entry_cls)
    finally:
        torch.set_num_threads(threads)
