"""The four-rank cell ``mesh-kicked-10q`` on the CPU: its entry runs
``generate(mesh=)`` on four persistent gloo ranks through ``run_cell(...,
chips=4)`` with the cards faked, at a tiny size (nq 4, 64 circuits a
call). Every rank reports its peak; a traced run folds the ranks' spans;
ranks whose labels differ fail the call; the faults planted in the
driving process reach the ranks, and the exchange's fault reads not
correct."""
import pytest
import torch

from qem_bench import faults, run, spec
from qem_bench.entries import kicked_mesh
from helpers import BENCH, FakeCards
from mlqem_tpu_torch.utils.profiling import reset_spans, span_totals

CELL = "mesh-kicked-10q"
GIB = 2 ** 30
CALLS = 3


class Recorded(kicked_mesh.Entry):
    """The program's entry, keeping what ``device_peaks()`` returned."""
    peaks = None

    def device_peaks(self):
        type(self).peaks = super().device_peaks()
        return type(self).peaks


def _run(entry_cls=None, trace=False, metrics=True):
    """One run of the tiny cell; ``metrics`` False reads none (a run whose
    every call failed has no latency to read)."""
    c = spec.cell(BENCH, CELL)
    cfg, traffic = spec.config(c["config"]), spec.traffic(c["traffic"])
    cfg["nq"] = 4
    traffic.update(batch=64, trace_calls=2, check={
        "ideal_calls": 2, "noisy_circuits": 256, "ref_traj": 1024})
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    try:
        return run.run_cell(
            CELL, cfg, traffic, spec.limits(CELL),
            spec.metrics_for(BENCH, "end_to_end", CELL) if metrics else [],
            spec.metrics_for(BENCH, "per_layer", CELL), 2 ** 31 + 21, 0.0,
            trace, "cpu", spec.reader, lambda: 0.0,
            stop=lambda i, el: i < CALLS, entry_cls=entry_cls, chips=4,
            cards=FakeCards({d: GIB for d in range(4)}))
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_spans():
    reset_spans()
    yield
    reset_spans()


def test_four_ranks_correct_with_a_peak_each():
    res = _run(Recorded)
    assert res["correct"], res["checks"]
    assert res["attempted"] == CALLS and res["failed"] == 0
    assert sorted(Recorded.peaks) == [0, 1, 2, 3]
    assert res["device"]["count"] == 4
    assert len(res["device"]["memory_peak_bytes_per_device"]) == 4
    # no peak on the CPU, so no peak_mem_gib
    assert {"pairs_per_min", "call_p95_ms", "setup_s"} <= set(res["metrics"])


def test_traced_run_folds_every_ranks_spans():
    res = _run(trace=True)
    totals = span_totals()
    for r in range(4):
        pre = f"mesh.rank{r}/kicked.generate"
        assert totals[pre]["count"] == 2
        for path in ("kicked.frame/kicked.draws", "kicked.readout/mesh.gather",
                     "kicked.readout/kicked.shots", "kicked.ideal/mesh.gather"):
            assert totals[f"{pre}/{path}"]["count"] == 2, path
    # host times on the CPU; the device times are the card's alone
    assert res["metrics"]["mesh.rank_ms"]["value"] > 0
    assert "mesh.gather_ms" not in res["metrics"]


def test_ranks_whose_labels_differ_fail_every_call():
    res = _run(kicked_mesh.with_fault("rank_diverges"), metrics=False)
    assert res["failed"] == res["attempted"] == CALLS
    assert not res["correct"]


def test_rows_gathered_in_another_ranks_place_read_not_correct():
    res = _run(kicked_mesh.with_fault("rows_swapped"))
    assert res["failed"] == 0
    assert not res["correct"]
    assert res["checks"]["ideal_max_err"]["value"] > 1e-2


@pytest.mark.parametrize("name", faults.FAULTS)
def test_a_fault_planted_here_reaches_the_ranks(name):
    with faults.plant(name):
        res = _run()
    assert res["failed"] == 0 and not res["correct"], res["checks"]
    if name == "answer_altered":
        assert res["checks"]["ideal_max_err"]["value"] >= 9e-4


@pytest.mark.parametrize("name", faults.FAULTS)
def test_planted_fault_names_the_fault(name):
    assert kicked_mesh.planted_fault() is None
    with faults.plant(name):
        assert kicked_mesh.planted_fault() == name
    assert kicked_mesh.planted_fault() is None


def test_unknown_fault_refused():
    with pytest.raises(KeyError):
        kicked_mesh.with_fault("no_such_fault")
