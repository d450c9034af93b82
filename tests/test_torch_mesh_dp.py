"""``KickedIsingEngine.generate(mesh=)`` over four data-parallel ranks, as
the benchmark's four-card deployment runs it (a (dp 4, sp 1) mesh): every
rank returns the unsharded call's labels, shots included, and records the
spans of what the mesh adds (``mesh.gather``, the whole batch's
``kicked.draws`` and ``kicked.shots``).

Four gloo ranks on the CPU run the small case in one ``spawn`` (a module
fixture); the ``cuda`` test runs four NCCL ranks, one a card, at the
deployment's widths and skips with fewer than four cards. This file
imports neither JAX nor ``mlqem_tpu``::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_mesh_dp.py
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mlqem_tpu_torch import KickedIsingEngine, configurable_device
from mlqem_tpu_torch.parallel.mesh import make_mesh, mesh_device, spawn
from mlqem_tpu_torch.utils.profiling import reset_spans, span_totals, tracing

RANKS = 4
SMALL = dict(nq=6, steps=2, n_traj=8, shots=1000)
MESH_SPANS = ["kicked.generate/kicked.frame/kicked.draws",
              "kicked.generate/kicked.readout/mesh.gather",
              "kicked.generate/kicked.readout/kicked.shots",
              "kicked.generate/kicked.ideal/mesh.gather"]


def rank_labels(kwargs, J, seed, device):
    """On this rank: the unsharded labels, then the labels on a (dp, 1)
    mesh over every rank under ``tracing()``, and that call's span counts;
    every rank's three, in rank order."""
    mesh = make_mesh(dp=dist.get_world_size(), sp=1, device=device)
    eng = KickedIsingEngine(configurable_device(kwargs["nq"], seed=0),
                            device=mesh_device(mesh), **kwargs)
    unsharded = eng.generate(J, seed=seed)
    reset_spans()
    with tracing():
        sharded = eng.generate(J, seed=seed, mesh=mesh)
    counts = {p: t["count"] for p, t in span_totals().items()}
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, (unsharded, sharded, counts))
    return everyone


@pytest.fixture(scope="module")
def runs():
    J = np.random.default_rng(6).uniform(0.05, 0.6, 64).astype(np.float32)
    return spawn(rank_labels, RANKS, "cpu", SMALL, J, 11, "cpu")


@pytest.mark.parametrize("rank", range(RANKS))
def test_every_rank_returns_the_unsharded_labels(runs, rank):
    want = runs[0][0]
    unsharded, sharded, _ = runs[rank]
    for got in (unsharded, sharded):
        for g, w in zip(got, want):
            assert g.shape == (64, SMALL["nq"])
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
    # the noise and the shots move the labels
    assert np.abs(want[1] - want[0]).mean() > 1e-3


@pytest.mark.parametrize("rank", range(RANKS))
def test_every_rank_records_the_mesh_spans(runs, rank):
    counts = runs[rank][2]
    assert counts["kicked.generate"] == 1
    for path in MESH_SPANS:
        assert counts[path] == 1, path


@pytest.mark.cuda
def test_four_cards_return_the_unsharded_labels():
    """Four NCCL ranks, one a card: the deployment's circuit (nq 10, 4
    steps, 32 trajectories, 10,000 shots) at 4,096 circuits."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < RANKS:
        pytest.skip(f"needs {RANKS} NVIDIA GPUs (sm_90) and nvcc")
    J = np.random.default_rng(7).uniform(0.05, 0.6, 4096).astype(np.float32)
    runs = spawn(rank_labels, RANKS, "cuda",
                 dict(nq=10, steps=4, n_traj=32, shots=10000), J, 12, "cuda")
    want = runs[0][0]
    for rank, (unsharded, sharded, counts) in enumerate(runs):
        for got in (unsharded, sharded):
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
        for path in MESH_SPANS:
            assert counts[path] == 1, (rank, path)
