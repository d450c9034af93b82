"""The harness on the card (marked ``cuda``; skips without one): the
kernels' paths come out correct and their control does not, and the
profiler's trace gives device time to the spans. At sizes a test run
holds; the cells' own sizes are read by ``python -m qem_bench.readings``.

    python -m pytest -p no:cacheprovider -m cuda \
        qem_bench/tests/test_bench_cuda.py
"""
import importlib

import pytest
import torch

from qem_bench import run, spec
from helpers import BENCH

pytestmark = pytest.mark.cuda

SMALL = {
    "kicked10q.labels": ({}, {"batch": 2048, "check": {
        "ideal_calls": 3, "noisy_circuits": 256, "ref_traj": 1024}}, 3),
    "lightcone100q.nf1": ({}, {"n_traj": 256, "check": {
        "noisy_steps": 3, "noisy_calls": 10, "ref_traj": 4096}}, 10),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90) and nvcc")
    return "cuda"


def _run(cell, cuda_device, entry_cls=None, trace=False):
    c = spec.cell(BENCH, cell)
    cfg, traffic = spec.config(c["config"]), spec.traffic(c["traffic"])
    over_cfg, over_traffic, calls = SMALL[cell]
    cfg.update(over_cfg)
    traffic.update(over_traffic)
    return run.run_cell(
        cell, cfg, traffic, spec.limits(cell),
        spec.metrics_for(BENCH, "end_to_end", cell),
        spec.metrics_for(BENCH, "per_layer", cell), 2 ** 31 + 77, 0.0,
        trace, cuda_device, spec.reader, lambda: 0.0,
        stop=lambda i, el: i < calls, entry_cls=entry_cls)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_program_correct_control_not(cell, cuda_device):
    assert _run(cell, cuda_device)["correct"]
    entry = spec.traffic(spec.cell(BENCH, cell)["traffic"])["entry"]
    ctl = _run(cell, cuda_device, importlib.import_module(
        f"qem_bench.entries.{entry}").Control)
    assert not ctl["correct"]


def test_trace_gives_device_time_to_spans(cuda_device):
    res = _run("kicked10q.labels", cuda_device, trace=True)
    assert res["device"]["busy_s"] > 0
    assert res["device"]["window_s"] >= res["device"]["busy_s"]
    for name in ("kicked.frame_ms", "kicked.readout_ms",
                 "kicked.evolve_roofline", "idle_pct.kicked"):
        assert name in res["metrics"]
    assert 0 < res["metrics"]["kicked.evolve_roofline"]["value"] <= 105


def test_ranks_on_every_card_are_counted(cuda_device):
    """A stub entry whose calls run on persistent NCCL ranks, one on each
    visible card, started by ``mesh.spawn``; the harness's process
    allocates nothing. The line counts every rank's card, read from the
    cards, and reports the ranks' own peaks."""
    import mesh_stub

    world, numel = torch.cuda.device_count(), 1 << 24
    res = run.run_cell(
        "stub", {}, {"entry": "kicked", "numel": numel}, {"sum_err": 0.0},
        spec.metrics_for(BENCH, "end_to_end", "stub"), [], 2 ** 31 + 79,
        0.0, False, cuda_device, spec.reader, lambda: 0.0,
        stop=lambda i, el: i < 3, entry_cls=mesh_stub.Entry, chips=world)
    dev = res["device"]
    print(f"cards seen: {world}; device: {dev}")
    assert res["correct"], res["checks"]
    assert dev["count"] == world
    assert dev["kind"] == torch.cuda.get_device_name(0)
    per = dev["memory_peak_bytes_per_device"]
    assert len(per) == world and min(per) >= 4 * numel
    assert dev["memory_peak_bytes"] == max(per)
