"""The line's ``device``: the devices a run used, read from the cards (faked
here), and the fullest one's peak; a run that used fewer devices than its
cell's ``chips``, or devices of different kinds, prints no line."""
import copy
import json
import sys
import types

import pytest
import torch

from qem_bench import cards, run, spec
from helpers import BENCH, H100, FakeCards, tiny_run

import mesh_stub

DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes",
               "memory_peak_bytes_per_device"}
GIB = 2 ** 30


class TwoPeaks:
    """An entry of one process that reports its devices' peaks."""

    def __init__(self, config, traffic, seed, device):
        self.peaks = traffic["peaks"]

    def warm(self):
        pass

    def inputs(self, i):
        return i

    def call(self, inputs):
        return 1, inputs

    def spans(self, spans):
        pass

    def release(self):
        pass

    def check(self, outputs, rng):
        return {}

    def device_peaks(self):
        return dict(self.peaks)


def _stub_run(entry_cls, traffic, limits, chips, fake, calls=2):
    return run.run_cell(
        "stub", {}, dict(traffic, entry="kicked"), limits,
        spec.metrics_for(BENCH, "end_to_end", "stub"), [], 2 ** 31 + 3, 0.0,
        False, "cpu", spec.reader, lambda: 0.0,
        stop=lambda i, el: i < calls, entry_cls=entry_cls, chips=chips,
        cards=fake)


def test_one_chip_line_keeps_its_keys_and_counts_one():
    res = tiny_run("kicked10q.labels", cards=FakeCards({0: 5 * GIB}))
    dev = res["device"]
    assert set(dev) == DEVICE_KEYS
    assert dev["platform"] == "gpu" and dev["kind"] == H100
    assert dev["count"] == 1
    # the harness's own peak, as before (nothing allocated on the CPU)
    assert dev["memory_peak_bytes"] == 0
    assert dev["memory_peak_bytes_per_device"] == [0]
    assert res["correct"]
    assert {"pairs_per_min", "call_p95_ms", "setup_s"} <= set(res["metrics"])


def test_cpu_line_without_cards():
    dev = tiny_run("kicked10q.labels")["device"]
    assert dev == {"platform": "cpu", "kind": "cpu", "count": 1,
                   "memory_peak_bytes": 0,
                   "memory_peak_bytes_per_device": [0]}


def test_two_devices_report_count_two_and_the_larger_peak():
    res = _stub_run(TwoPeaks, {"peaks": {0: 3 * GIB, 1: 5 * GIB}}, {}, 2,
                    FakeCards({0: 4 * GIB, 1: 6 * GIB}))
    dev = res["device"]
    assert dev["count"] == 2 and dev["kind"] == H100
    assert dev["memory_peak_bytes"] == 5 * GIB
    assert dev["memory_peak_bytes_per_device"] == [3 * GIB, 5 * GIB]
    assert res["metrics"]["peak_mem_gib"]["value"] == 5.0
    assert res["correct"]


@pytest.mark.parametrize("held,kinds,why", [
    ({1: GIB}, {}, "used 1 of the 2"),
    ({}, {}, "used 0 of the 2"),
    ({0: GIB, 1: GIB}, {1: "NVIDIA A100-SXM4-80GB"}, "different kinds"),
])
def test_run_cell_raises_on_a_device_fault(held, kinds, why):
    with pytest.raises(run.DeviceFault, match=why):
        _stub_run(TwoPeaks, {"peaks": {0: 1, 1: 1}}, {}, 2,
                  FakeCards(held, kinds))


@pytest.fixture
def stub_cell(monkeypatch):
    """``main`` on a stub cell of 2 chips (the entry ``TwoPeaks``), on the
    CPU, with the cards it reads given by the test."""
    bench = copy.deepcopy(BENCH)
    bench["workloads"].append({"name": "stub.two", "config":
                               "kicked-ising-10q", "traffic": "stub",
                               "chips": 2, "why": "two devices"})
    traffic, limits = spec.traffic, spec.limits
    monkeypatch.setattr(spec, "benchmark", lambda root: bench)
    monkeypatch.setattr(spec, "traffic", lambda name: (
        {"entry": "stub", "peaks": {0: GIB, 1: 2 * GIB}}
        if name == "stub" else traffic(name)))
    monkeypatch.setattr(spec, "limits", lambda name: (
        {} if name == "stub.two" else limits(name)))
    monkeypatch.setitem(sys.modules, "qem_bench.entries.stub",
                        types.SimpleNamespace(Entry=TwoPeaks))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "USE_FLAX"):
        monkeypatch.setenv(var, "unused")
    real = run.run_cell

    def main(fake):
        monkeypatch.setattr(run, "run_cell", lambda *a, **k: real(
            *a, **dict(k, device="cpu", cards=fake)))
        return run.main(["--workload", "stub.two", "--seed",
                         str(2 ** 31 + 11), "--seconds", "0"])
    return main


@pytest.mark.parametrize("held,kinds,why", [
    ({0: GIB}, {}, "used 1 of the 2 device"),
    ({0: GIB, 1: GIB}, {0: "NVIDIA A100-SXM4-80GB"}, "different kinds"),
])
def test_main_prints_no_line_on_a_device_fault(stub_cell, capsys, held,
                                                kinds, why):
    rc = stub_cell(FakeCards(held, kinds))
    out, err = capsys.readouterr()
    assert rc != 0 and out == ""
    assert why in err and "stub.two" in err


def test_main_prints_the_line_when_every_device_is_used(stub_cell, capsys):
    rc = stub_cell(FakeCards({0: GIB, 1: 3 * GIB}))
    out, _ = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"]
    assert line["device"]["count"] == 2
    assert line["device"]["memory_peak_bytes"] == 2 * GIB
    assert line["device"]["memory_peak_bytes_per_device"] == [GIB, 2 * GIB]


def test_persistent_ranks_report_their_peaks():
    """The stub of the ``cuda`` test, on the CPU: two gloo ranks through
    ``mesh.spawn``, alive until ``release()``, each reporting its peak."""
    numel = 1 << 16
    res = _stub_run(mesh_stub.Entry, {"ranks": 2, "numel": numel},
                    {"sum_err": 0.0}, 2, FakeCards({0: 1, 1: 1}), calls=3)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 3
    assert res["device"]["memory_peak_bytes_per_device"] == [4 * numel] * 2
    assert res["device"]["memory_peak_bytes"] == 4 * numel


@pytest.mark.parametrize("fall,reserve,used", [
    ({}, {}, {}),
    ({1: 2 * GIB}, {0: GIB}, {0: GIB, 1: 2 * GIB}),
    ({0: GIB, 2: 600 * 2 ** 20}, {0: 3 * GIB}, {0: 3 * GIB,
                                               2: 600 * 2 ** 20}),
    ({1: 2 ** 19}, {}, {}),
])
def test_cards_read_the_fall_in_free_memory(monkeypatch, fall, reserve,
                                            used):
    """A device is used where its free memory fell since set-up (a rank's
    context and buffers) or the harness's own allocator holds memory."""
    free = {0: 70 * GIB, 1: 70 * GIB, 2: 70 * GIB}
    reserved = {0: 0, 1: 0, 2: 0}
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda i: (free[i], 80 * GIB))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda i: reserved[i])
    c = cards.Cards(3)
    for d, n in fall.items():
        free[d] -= n
    reserved.update(reserve)
    assert c.used() == used
