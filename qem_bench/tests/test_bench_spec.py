"""BENCHMARK.json and the files it names: every configuration, traffic mix,
limits file and metric reader is found by its name."""
import os
import re

import pytest

from qem_bench import spec
from helpers import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["qem_bench"]
    assert BENCH["command"][:3] == ["python3", "-m", "qem_bench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configs_found_by_name(cfg):
    assert NAME.match(cfg["name"])
    assert cfg["file"] == f"qem_bench/configs/{cfg['name']}.json"
    body = spec.config(cfg["name"])
    assert body["name"] == cfg["name"]
    assert body["reduced"] == cfg["reduced"] == []
    assert body["precision"] == "float32"
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells_find_their_pieces(cell):
    assert NAME.match(cell["name"]) and cell["chips"] == 1
    assert len(cell["why"]) <= 200
    traffic = spec.traffic(cell["traffic"])
    assert os.path.exists(os.path.join(spec.HERE, "entries",
                                       f"{traffic['entry']}.py"))
    assert set(spec.limits(cell["name"])) <= {
        "ideal_max_err", "noisy_chi2_dev", "noisy_bias_z"}
    e2e = spec.metrics_for(BENCH, "end_to_end", cell["name"])
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    layer = spec.metrics_for(BENCH, "per_layer", cell["name"])
    assert layer and {m["moves"] for m in layer} <= {m["name"] for m in e2e}


@pytest.mark.parametrize("kind,metric", [
    (kind, m) for kind in ("end_to_end", "per_layer") for m in BENCH[kind]],
    ids=lambda x: x if isinstance(x, str) else x["name"])
def test_metric_readers_found_by_name(kind, metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    folder = "end_to_end" if kind == "end_to_end" else "layer_metrics"
    assert callable(spec.reader(folder, metric["name"]))
    if kind == "end_to_end":
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
    if "roofline" in metric["name"]:
        assert metric["name"].endswith("_roofline") and metric["unit"] == "%"


def test_layers_named_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) >= 1 for v in layers.values())
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024
