"""The port's spans (``mlqem_tpu_torch.utils.profiling.span``): the
recorder's aggregates, the paths each engine records, the off path, and
(marked ``cuda``) the spans as ranges of a profiler trace of the card.

This file imports neither JAX nor ``mlqem_tpu``, so its ``cuda`` test also
runs where only PyTorch is installed::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_spans.py
"""
import json
import time

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler

from mlqem_tpu_torch import (KickedIsingEngine, LightconeIsing,
                             configurable_device)
from mlqem_tpu_torch.ops.kernels import evolve as kev
from mlqem_tpu_torch.ops.kernels import fused_step as kfs
from mlqem_tpu_torch.utils.profiling import (fold_spans, reset_spans, span,
                                             span_totals, trace, tracing)
from mlqem_tpu_torch.workflows.zne_scale import zne_sweep_ising

from port_fixtures import one_torch_thread  # noqa: F401

KICKED = ["kicked.frame", "kicked.frame/kicked.draws", "kicked.evolve",
          "kicked.readout", "kicked.readout/kicked.confusion",
          "kicked.readout/kicked.shots", "kicked.ideal"]


@pytest.fixture(autouse=True)
def _fresh_spans():
    reset_spans()
    yield
    reset_spans()


def _cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _counts():
    return {p: t["count"] for p, t in span_totals().items()}


def _kicked(device, nq=5, **kw):
    return KickedIsingEngine(configurable_device(nq, seed=0), nq=nq, steps=2,
                             device=device, n_traj=4, shots=100, **kw)


def _lightcone(device):
    """nq 8, 3 steps: windows of 7 qubits, 2 chunks of 2 realizations."""
    return LightconeIsing(configurable_device(8, seed=1), nq=8, steps=3,
                          device=device, n_traj=4, t_chunk=2, shots=49)


@pytest.mark.parametrize("recording", [tracing, _cpu_profile])
def test_recorder_aggregates_paths_self_time_and_counts(recording):
    with recording():
        for _ in range(2):
            with span("outer"):
                time.sleep(0.002)
                with span("inner"):
                    time.sleep(0.003)
                with span("inner"):
                    pass
        with span("inner"):
            pass
    totals = span_totals()
    assert list(totals) == ["outer", "outer/inner", "inner"]
    assert [t["count"] for t in totals.values()] == [2, 4, 1]
    outer, inner = totals["outer"], totals["outer/inner"]
    assert inner["host_s"] >= 0.006 and outer["host_s"] >= 0.010
    assert outer["self_host_s"] == pytest.approx(
        outer["host_s"] - inner["host_s"], abs=1e-9)
    assert inner["self_host_s"] == inner["host_s"]
    assert all(t["device_s"] is None for t in totals.values())   # no CUDA
    with span("outer"):                     # off: neither profiler nor
        pass                                # tracing()
    assert _counts() == {"outer": 2, "outer/inner": 4, "inner": 1}
    reset_spans()
    assert span_totals() == {}


def test_profiler_flag_reads_true_inside_a_profile_only():
    assert autograd_profiler._is_profiler_enabled is False
    with _cpu_profile() as prof:
        assert autograd_profiler._is_profiler_enabled is True
        with span("outer"):
            torch.ones(8).cumsum(0)
    assert autograd_profiler._is_profiler_enabled is False
    assert "outer" in {e.name for e in prof.events()}
    assert _counts() == {"outer": 1}


def test_kicked_engine_span_paths_in_order():
    with tracing():
        eng = _kicked("cpu")
        eng.generate(np.array([0.2, 0.4], np.float32), seed=3)
    nb = len(eng.bonds)
    assert _counts() == {
        "kicked.engine": 1, "kicked.engine/trajectory.twirl": nb,
        "kicked.generate": 1,
        **{"kicked.generate/" + p: 1 for p in KICKED}}
    assert list(span_totals()) == (
        ["kicked.engine", "kicked.engine/trajectory.twirl", "kicked.generate"]
        + ["kicked.generate/" + p for p in KICKED])


def test_lightcone_span_paths_in_order():
    eng = _lightcone("cpu")
    with tracing():
        eng.generate_stepwise(np.array([0.3], np.float32), qubits=[3],
                              seed=2)
    top, chunk = "lightcone.generate_stepwise", "lightcone.chunk"
    steps, chunks = 3, 2
    nb = len(eng.window_tables(3)["bonds"])
    want = {
        top: 1,
        f"{top}/lightcone.tables": 1,
        f"{top}/lightcone.tables/trajectory.twirl": nb,
        f"{top}/{chunk}": chunks,
        f"{top}/{chunk}/lightcone.frame": chunks,
        f"{top}/{chunk}/lightcone.evolve": chunks,
        f"{top}/{chunk}/lightcone.evolve/kicked.step": steps * chunks,
        f"{top}/{chunk}/lightcone.evolve/lightcone.z": steps * chunks,
        f"{top}/{chunk}/lightcone.shots": chunks,
        f"{top}/lightcone.ideal": 1,
        f"{top}/lightcone.ideal/kicked.step": steps,
        f"{top}/lightcone.ideal/lightcone.z": steps}
    assert _counts() == want
    assert list(span_totals()) == list(want)


def test_zne_sweep_span_paths_in_order():
    with tracing():
        zne_sweep_ising(configurable_device(4, seed=0), nq=4, steps=2,
                        J_values=np.array([0.2, 0.5], np.float32),
                        n_traj=4, shots=100, device="cpu")
    nb = 3
    want = {"zne.sweep": 1, "zne.sweep/kicked.engine": 2,
            "zne.sweep/kicked.engine/trajectory.twirl": 2 * nb,
            "zne.sweep/kicked.generate": 2,
            **{"zne.sweep/kicked.generate/" + p: 2 for p in KICKED}}
    assert _counts() == want
    assert list(span_totals()) == list(want)


def test_off_path_records_nothing_and_enters_no_range(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    assert span("kicked.generate") is span("lightcone.z")
    _kicked("cpu").generate(np.array([0.2, 0.4], np.float32), seed=3)
    _lightcone("cpu").generate_stepwise(np.array([0.3], np.float32),
                                        qubits=[3], seed=2)
    zne_sweep_ising(configurable_device(4, seed=0), nq=4, steps=2,
                    J_values=np.array([0.2, 0.5], np.float32), n_traj=4,
                    shots=100, device="cpu")
    assert span_totals() == {}


def test_folded_totals_land_under_their_prefix():
    """Another process's totals (a rank's ``span_totals()``) add to this
    process's under a prefix, with their counts and times; folding twice
    adds; ``reset_spans()`` drops them."""
    rank = {"kicked.generate": {"count": 2, "host_s": 0.5,
                                "self_host_s": 0.125, "device_s": 0.25},
            "kicked.generate/mesh.gather": {"count": 4, "host_s": 0.375,
                                            "self_host_s": 0.375,
                                            "device_s": None}}
    with tracing():
        with span("kicked.generate"):
            pass
    fold_spans(rank, "mesh.rank1/")
    got = span_totals()
    assert list(got) == ["kicked.generate", "mesh.rank1/kicked.generate",
                         "mesh.rank1/kicked.generate/mesh.gather"]
    assert got["kicked.generate"]["count"] == 1
    assert got["mesh.rank1/kicked.generate"] == rank["kicked.generate"]
    assert got["mesh.rank1/kicked.generate/mesh.gather"] == \
        rank["kicked.generate/mesh.gather"]
    fold_spans(rank, "mesh.rank1/")
    fold_spans(rank, "mesh.rank2/")
    twice = span_totals()["mesh.rank1/kicked.generate"]
    assert twice == {"count": 4, "host_s": 1.0, "self_host_s": 0.25,
                     "device_s": 0.5}
    assert span_totals()["mesh.rank2/kicked.generate"]["count"] == 2
    reset_spans()
    assert span_totals() == {}


def test_trace_writes_the_blocks_span_aggregates(tmp_path):
    with tracing():
        with span("before"):
            pass
    with trace(str(tmp_path)):
        _kicked("cpu").generate(np.array([0.2], np.float32), seed=1)
    with open(tmp_path / "spans.json") as f:
        spans = json.load(f)
    assert list(spans) == (["kicked.engine", "kicked.engine/trajectory.twirl",
                            "kicked.generate"]
                           + ["kicked.generate/" + p for p in KICKED])
    assert spans["kicked.generate"]["count"] == 1
    assert (tmp_path / "trace.json").exists()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90) and nvcc")
    return torch.device("cuda")


def _ranges(events, names):
    """(start, end, name) of the trace's ranges whose names are in
    ``names``, and each kernel's launch time by its correlation id."""
    ranges, launch, kernels = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        if cat == "user_annotation" and name in names:
            ranges.append((ts, end, name))
        elif cat in ("cuda_runtime", "cuda_driver") and \
                "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = ts
        elif cat == "kernel":
            kernels.append((name, e["args"].get("correlation")))
    return ranges, [(n, launch[c]) for n, c in kernels if c in launch]


@pytest.mark.cuda
def test_spans_are_ranges_of_a_card_trace(cuda_device, tmp_path):
    """One generate (K1 at nq 5) and one generate_stepwise (K3's chip tier
    at w = 7): every span is a range of the trace, K1 launches inside
    ``kicked.evolve``, K3 inside each ``kicked.step``; device time > 0."""
    eng, lc = _kicked(cuda_device), _lightcone(cuda_device)
    J = np.array([0.2, 0.4], np.float32)
    eng.generate(J, seed=3)                             # builds, warms
    lc.generate_stepwise(J[:1], qubits=[3], seed=2)
    k1, k3 = kev.evolve_fused.launches, kfs.fused_trotter_step.launches
    with trace(str(tmp_path)):
        eng.generate(J, seed=4)
        lc.generate_stepwise(J[:1], qubits=[3], seed=5)
    assert kev.evolve_fused.launches == k1 + 2
    assert kfs.fused_trotter_step.launches == k3 + 3 * 3
    totals = span_totals()
    names = {p.rsplit("/", 1)[-1] for p in totals}
    with open(tmp_path / "trace.json") as f:
        ranges, launched = _ranges(json.load(f)["traceEvents"], names)
    assert {n for _, _, n in ranges} == names
    for path, t in totals.items():
        assert t["device_s"] is not None and t["device_s"] > 0, path
    assert totals["kicked.generate/kicked.evolve"]["device_s"] > 0

    def inside(name, kernel):
        spans = [(a, b) for a, b, n in ranges if n == name]
        hits = [ts for k, ts in launched if kernel in k]
        return spans, [sum(a <= ts <= b for ts in hits) for a, b in spans]

    # K1 and K3's chip tier are both kicked_kernel<nq, packed>
    spans, hits = inside("kicked.evolve", "kicked_kernel")
    assert len(spans) == 1 and hits == [1]      # K1 once in the noisy arm
    spans, hits = inside("kicked.step", "kicked_kernel")
    assert len(spans) == 3 * 3 and hits == [1] * 9
