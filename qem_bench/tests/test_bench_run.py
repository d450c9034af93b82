"""A run's last line, and the runs that must print none."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from helpers import ROOT, tiny_run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_has_the_contract_keys(trace):
    res = tiny_run("kicked10q.labels", trace=trace)
    keys = list(res)
    assert keys[-1] == "checks"
    assert set(keys) == set(KEYS) | {"checks"} | (
        {"breakdown"} if trace else set())
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] == 3
    assert {"platform", "kind", "count", "memory_peak_bytes",
            "memory_peak_bytes_per_device"} <= set(res["device"])
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert {"pairs_per_min", "call_p95_ms", "setup_s"} <= set(
            res["metrics"])
    json.dumps(res)


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "qem_bench.run", "--workload",
         "kicked10q.labels", "--seed", str(2 ** 31 + 9), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_without_a_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _run(ROOT, env)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA device" in proc.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "qem_bench"), tmp_path / "qem_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""
