"""The port's device mesh and the ``mesh=`` branch of both label generators
against the unsharded calls and against the JAX package's sharded ones.

Four gloo ranks on the CPU, a (dp 2, sp 2) mesh, run every case in one
``spawn`` (a module fixture): the ranks that share a dp index compute the
same rows (JAX's ``P("dp")`` replicates over sp); each rank runs a
generator unsharded, on the mesh, then unsharded again on the same engine
(the order that JAX's ``test_compile_cache_keyed_on_mesh`` guards). The
dry run shards the generators over 4 dp ranks
(``tests/test_torch_dryrun.py``).
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax

from mlqem_tpu.device.registry import get_device as jax_get_device
from mlqem_tpu.ops.kicked_ising import KickedIsingEngine as JaxKicked
from mlqem_tpu.parallel.datagen import IsingLabelPipeline as JaxPipeline
from mlqem_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mlqem_tpu.parallel.mesh import pad_to_multiple as jax_pad

from mlqem_tpu_torch import (IsingLabelPipeline, KickedIsingEngine,
                             configurable_device, get_device)
from mlqem_tpu_torch.entry import mesh_label_runs
from mlqem_tpu_torch.parallel.mesh import make_mesh, pad_to_multiple, spawn

from port_fixtures import bounded_rank_wait, one_torch_thread  # noqa: F401

RANKS = 4
J16 = np.linspace(0.1, 0.5, 16).astype(np.float32)
LIMA = dict(nq=4, steps=2, dt=0.5)
JOBS = {
    # JAX's test_parallel.py configurations (shots=None)
    "kicked": (KickedIsingEngine, get_device("fake_lima"),
               dict(LIMA, n_traj=16, shots=None), J16, 0),
    "density_matrix": (IsingLabelPipeline, get_device("fake_lima"),
                       dict(LIMA, shots=None), J16, 0),
    "frame": (IsingLabelPipeline, configurable_device(4, seed=0),
              dict(LIMA, shots=None, method="frame", n_traj=8), J16, 1),
    # batches that do not split over 2 dp ranks, with shots
    "kicked_pad_shots": (KickedIsingEngine, get_device("fake_lima"),
                         dict(LIMA, n_traj=8, shots=1000), J16[:9], 3),
    "trajectory_pad_shots": (
        IsingLabelPipeline, get_device("fake_lima"),
        dict(LIMA, shots=1000, method="trajectory", n_traj=8), J16[:7], 4),
    "density_matrix_pad_shots": (IsingLabelPipeline, get_device("fake_lima"),
                                 dict(LIMA, shots=500), J16[:5], 5),
}


@pytest.fixture(scope="module")
def runs():
    out = spawn(mesh_label_runs, RANKS, "cpu", list(JOBS.values()), 2, 2,
                "cpu")
    return dict(zip(JOBS, out))


def test_mesh_helpers_match_jax():
    for shape, multiple in (((5, 3), 8), ((8, 2), 4), ((7,), 2)):
        a = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
        got, n = pad_to_multiple({"a": a}, multiple)
        want, n_jax = jax_pad({"a": a}, multiple)
        assert n == n_jax == shape[0]
        np.testing.assert_array_equal(got["a"], want["a"])
    assert jax_make_mesh().shape["dp"] == len(jax.devices())


def test_make_mesh_starts_a_one_rank_group():
    assert not dist.is_initialized()
    try:
        mesh = make_mesh(device="cpu")
        assert dist.get_world_size() == 1
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("dp", "sp")
        with pytest.raises(ValueError, match="dp\\*sp"):
            make_mesh(dp=2, sp=1, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("job", list(JOBS))
def test_sharded_equals_unsharded(runs, job):
    """Every rank draws the whole batch's noise and the shots are drawn
    after the all-gather, so the sharded labels equal the unsharded ones,
    shots included; and a sharded call leaves the engine as it was."""
    unsharded, sharded, again = runs[job]
    n = len(JOBS[job][3])
    for got, want in ((sharded, unsharded), (again, unsharded)):
        for g, w in zip(got, want):
            assert g.shape == (n, 4)
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
    # the noise moves the labels
    assert np.abs(unsharded[1] - unsharded[0]).mean() > 1e-3


@pytest.mark.parametrize("job", ["kicked", "density_matrix"])
def test_sharded_ideal_matches_jax_sharded(runs, job):
    """The ideal arm is deterministic: the port's sharded ideal labels
    against JAX's sharded ``generate`` on the 8-device CPU mesh."""
    dev = jax_get_device("fake_lima")
    if job == "kicked":
        eng = JaxKicked(dev, n_traj=16, shots=None, use_pallas=False, **LIMA)
    else:
        eng = JaxPipeline(dev, shots=None, **LIMA)
    ideal, _ = eng.generate(J16, seed=0, mesh=jax_make_mesh())
    np.testing.assert_allclose(runs[job][1][0], ideal, atol=1e-5, rtol=0)


def test_sharded_rows_cover_the_batch_once():
    """The dp blocks with the pad cut off are the batch in order."""
    class _Mesh:
        def __init__(self, d, dp):
            self.d, self.dp = d, dp

        def size(self, dim):
            return self.dp

        def get_local_rank(self, name):
            return self.d

    from mlqem_tpu_torch.parallel.mesh import shard_rows

    for n, dp in ((16, 4), (10, 4), (3, 4), (7, 2)):
        rows = torch.cat([shard_rows(n, _Mesh(d, dp)) for d in range(dp)])
        padded, _ = pad_to_multiple({"i": np.arange(n)}, dp)
        np.testing.assert_array_equal(rows.numpy(), padded["i"])
