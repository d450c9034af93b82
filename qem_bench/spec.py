"""Finds a cell's pieces by name: the cell and its metrics in
``BENCHMARK.json``, ``configs/<config>.json``, ``traffic/<mix>.json``,
``limits/<cell>.json``, ``end_to_end/<metric>.py`` and
``layer_metrics/<metric>.py``."""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(name: str) -> dict:
    return load_json(os.path.join(HERE, "configs", f"{name}.json"))


def traffic(name: str) -> dict:
    return load_json(os.path.join(HERE, "traffic", f"{name}.json"))


def limits(cell_name: str) -> Dict[str, float]:
    return load_json(os.path.join(HERE, "limits", f"{cell_name}.json"))


def metrics_for(bench: dict, kind: str, cell_name: str) -> List[dict]:
    """The ``kind`` ("end_to_end" or "per_layer") metrics a cell reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def reader(kind: str, name: str) -> Callable:
    """``read`` of ``<kind>/<name>.py``."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"qem_bench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
