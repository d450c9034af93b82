"""The four-card cell ``mesh-kicked-10q`` on four cards (marked ``cuda``;
skips with fewer): at a small batch its program comes out correct and
counts four cards, its control (the reference in TF32, each card its
share) and the exchange's fault do not. The cell's own sizes are read by
``python -m qem_bench.readings``.

    python -m pytest -p no:cacheprovider -m cuda \
        qem_bench/tests/test_bench_mesh_cuda.py
"""
import pytest
import torch

from qem_bench import run, spec
from qem_bench.entries import kicked_mesh
from helpers import BENCH

pytestmark = pytest.mark.cuda

CELL = "mesh-kicked-10q"
CALLS = 3


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 NVIDIA GPUs (sm_90) and nvcc")
    return "cuda"


def _run(device, entry_cls=None):
    c = spec.cell(BENCH, CELL)
    cfg, traffic = spec.config(c["config"]), spec.traffic(c["traffic"])
    traffic.update(batch=8192, check={
        "ideal_calls": 3, "noisy_circuits": 256, "ref_traj": 1024})
    return run.run_cell(
        CELL, cfg, traffic, spec.limits(CELL),
        spec.metrics_for(BENCH, "end_to_end", CELL), [], 2 ** 31 + 83, 0.0,
        False, device, spec.reader, lambda: 0.0,
        stop=lambda i, el: i < CALLS, entry_cls=entry_cls, chips=4)


def test_program_correct_on_four_cards(four_cards):
    res = _run(four_cards)
    print(f"program: {res['checks']}; device: {res['device']}")
    assert res["correct"], res["checks"]
    assert res["device"]["count"] == 4
    assert min(res["device"]["memory_peak_bytes_per_device"]) > 0


@pytest.mark.parametrize("entry", ["control", "rows_swapped"])
def test_control_and_exchange_fault_not_correct(four_cards, entry):
    cls = (kicked_mesh.Control if entry == "control"
           else kicked_mesh.with_fault(entry))
    res = _run(four_cards, cls)
    print(f"{entry}: {res['checks']}; device: {res['device']}")
    assert res["device"]["count"] == 4
    assert not res["correct"]
