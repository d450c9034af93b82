"""The port's amplitude-sharded statevector on 8 gloo ranks against the JAX
package's ``sharded_statevector_fn`` on the 8-device CPU mesh.

One ``spawn`` (a module fixture) runs every case; circuits cross from the
JAX package as ``Circuit.from_dict(jax_circuit.to_dict())``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from mlqem_tpu.circuits.circuit import Circuit as JaxCircuit
from mlqem_tpu.circuits.circuit import tensorize as jax_tensorize
from mlqem_tpu.circuits.families import (IsingModel, IsingOptions,
                                         random_circuit)
from mlqem_tpu.ops.sharded_sv import sharded_statevector_fn as jax_sharded
from mlqem_tpu.ops.sharded_sv import sharded_z_expectations as jax_sharded_z
from mlqem_tpu.ops.statevector import statevector as jax_statevector
from mlqem_tpu.parallel.mesh import make_mesh as jax_make_mesh

from mlqem_tpu_torch.circuits.circuit import Circuit
from mlqem_tpu_torch.entry import sharded_sv_runs
from mlqem_tpu_torch.parallel.mesh import spawn

from port_fixtures import bounded_rank_wait, one_torch_thread  # noqa: F401

RANKS = 8


def _z_circuit():
    ops = dataclasses.replace(IsingOptions.config_4q_paper(), nq=5)
    return IsingModel.make_circs_sweep(ops, 2, "Z", measure=False)


def _sweep_circuit(theta=0.3):
    return JaxCircuit(4).rx(theta, 0).cx(0, 3).rz(0.5, 3).cx(1, 2)


def _one_local_qubit():
    """n=3 over sp=4: one local qubit; 1q gates on it, global 1q and 2q
    gates, and mixed gates with the local qubit first and second."""
    return (JaxCircuit(3).h(0).rx(0.4, 2).cx(2, 1).cx(0, 2).ry(0.7, 0)
            .cx(1, 0).rzz(0.3, 0, 1).h(1).cz(2, 0))


def _two_global_qubits():
    """n=5 over sp=8: gates on two global qubits in both orders."""
    return (JaxCircuit(5).h(2).h(3).h(4).cx(3, 4).rzz(0.6, 4, 2)
            .ry(0.3, 4).cx(2, 0).swap(3, 2).rx(0.2, 1).cx(4, 3))


def _params(qc):
    return np.asarray(jax_tensorize(qc).params)


CASES = {f"random_sp{sp}": (random_circuit(6, 5, seed=42), sp)
         for sp in (2, 4, 8)}
CASES["z_sp4"] = (_z_circuit(), 4)
CASES["one_local_qubit"] = (_one_local_qubit(), 4)
CASES["two_global_qubits"] = (_two_global_qubits(), 8)


@pytest.fixture(scope="module")
def runs():
    p1 = _params(_sweep_circuit())
    p2 = p1.copy()
    p2[0, 0] = 1.1
    jobs = [(Circuit.from_dict(qc.to_dict()), sp, [_params(qc)])
            for qc, sp in CASES.values()]
    jobs.append((Circuit.from_dict(_sweep_circuit().to_dict()), 2, [p1, p2]))
    out = spawn(sharded_sv_runs, RANKS, "cpu", jobs, "cpu")
    return {**dict(zip(CASES, out)), "sweep": out[-1]}


def _jax_mesh(sp):
    return jax_make_mesh(dp=len(jax.devices()) // sp, sp=sp)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_state_matches_jax(runs, case):
    """The state against JAX's sharded state (same op order, so the same
    global phase), and the ⟨Z_q⟩ against the state's own marginals."""
    qc, sp = CASES[case]
    psi, z = runs[case][0]
    want = jax_sharded(qc, _jax_mesh(sp))(jax_tensorize(qc).params)
    np.testing.assert_allclose(psi, np.asarray(want), atol=1e-5, rtol=0)
    probs = np.abs(psi) ** 2
    bits = (np.arange(probs.size)[:, None] >> np.arange(qc.num_qubits)) & 1
    np.testing.assert_allclose(z, probs @ (1 - 2 * bits), atol=1e-5, rtol=0)


def test_sharded_z_expectations_match_jax(runs):
    qc, sp = CASES["z_sp4"]
    mesh = _jax_mesh(sp)
    want = jax_sharded_z(jax_sharded(qc, mesh)(jax_tensorize(qc).params),
                         qc.num_qubits, mesh)
    np.testing.assert_allclose(runs["z_sp4"][0][1], want, atol=1e-5, rtol=0)


def test_sharded_param_sweep_reuses_the_structure(runs):
    (psi1, _), (psi2, _) = runs["sweep"]
    assert not np.allclose(psi1, psi2)
    ref = np.asarray(jax_statevector(jax_tensorize(_sweep_circuit(1.1))))
    np.testing.assert_allclose(psi2, ref, atol=1e-5, rtol=0)


def test_wide_ops_build_their_indices_where_the_state_lives(monkeypatch):
    """From ``_DEVICE_INDEX_N`` qubits on, ``apply_op`` builds a shared
    op's gather indices on the state's device (the wide single-rank state
    of ``chip_smoke.py`` phase 27): the same state as the host-built
    indices, bit for bit."""
    from mlqem_tpu_torch.circuits.circuit import tensorize
    from mlqem_tpu_torch.circuits.families import random_circuit as port_rc
    from mlqem_tpu_torch.ops import statevector as sv

    ct = tensorize(port_rc(sv._DEVICE_INDEX_N, 3, seed=11))
    device_built = sv.statevector(ct, device="cpu")
    monkeypatch.setattr(sv, "_DEVICE_INDEX_N", 99)
    host_built = sv.statevector(ct, device="cpu")
    assert torch.equal(device_built, host_built)
