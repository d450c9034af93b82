"""Port vs JAX package: the stabilizer tableau.

Tableaux are boolean and expectations exactly 0 or ±1, so both are held
equal to JAX's, bit for bit. The port applies a primitive stream as layers
of primitives on disjoint qubits; these tests hold that against JAX's
one-primitive-at-a-time scan, and the expectations against the port's f32
statevector (≤ 1e-5).
"""
import numpy as np
import pytest
import torch

import mlqem_tpu.ops.stabilizer as js
from mlqem_tpu.circuits.circuit import Circuit as JCircuit
from mlqem_tpu.circuits.observables import PauliSum as JPauliSum

import mlqem_tpu_torch.ops.stabilizer as ts
from mlqem_tpu_torch import Circuit, PauliSum, tensorize
from mlqem_tpu_torch.circuits.families import (generate_composed_clifford,
                                               random_clifford_circuit)
from mlqem_tpu_torch.circuits.observables import all_z
from mlqem_tpu_torch.ops.statevector import expval_pauli_sum, statevector

from port_fixtures import one_torch_thread  # noqa: F401

SV_TOL = 1e-5


def _jax(c):
    return JCircuit.from_dict(c.to_dict())


def _streams(circuits):
    streams = [ts.decompose_to_primitives(c) for c in circuits]
    L = max(t.shape[0] for t, _ in streams)
    types = np.full((len(circuits), L), ts._PRIM_NOP, np.int32)
    qubits = np.zeros((len(circuits), L, 2), np.int32)
    for i, (t, q) in enumerate(streams):
        types[i, :len(t)], qubits[i, :len(t)] = t, q
    return types, qubits


def test_decomposition_matches_jax():
    assert ts._CLIFFORD_DECOMP == js._CLIFFORD_DECOMP
    qc = Circuit(3)
    for name in sorted(ts.CLIFFORD_GATES - {"id"}):
        qc.append(name, (0, 2) if name in ("cx", "cz", "cy", "swap", "ecr")
                  else (1,))
    for name in ("rz", "p", "rx", "ry"):
        for k in range(-2, 6):
            qc.append(name, (2,), (k * np.pi / 2,))
    qc.id(0).measure_all()
    for a, b in zip(ts.decompose_to_primitives(qc),
                    js.decompose_to_primitives(_jax(qc))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="not a Clifford"):
        ts.decompose_to_primitives(Circuit(1).rx(0.3, 0))


@pytest.mark.parametrize("n", [3, 7, 33])
def test_tableau_bit_equal_to_jax(n):
    circuits = [random_clifford_circuit(n, 6, seed=s) for s in range(5)]
    circuits.append(Circuit(n))                      # an empty stream
    types, qubits = _streams(circuits)
    got = ts.run_tableau(types, qubits, n, device="cpu")
    want = js._run_tableau_batch(types, qubits, n)
    for g, w in zip(got, want):
        assert g.dtype == torch.bool
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # one stream, unbatched
    single = ts.run_tableau(types[0], qubits[0], n, device="cpu")
    for g, w in zip(single, got):
        assert torch.equal(g, w[0])
    # expectations of random Paulis, batched and through the state wrapper
    rng = np.random.default_rng(n)
    for _ in range(4):
        s = "".join(rng.choice(list("IXYZ")) for _ in range(n))
        np.testing.assert_array_equal(
            ts.batch_expectations(circuits, PauliSum(s), device="cpu"),
            js.batch_expectations([_jax(c) for c in circuits],
                                  JPauliSum(s)))
    state = ts.StabilizerState.from_circuit(circuits[1], device="cpu")
    assert state.stabilizer_strings() == js.StabilizerState(
        tuple(np.asarray(w[1]) for w in want), n).stabilizer_strings()


def test_expectations_match_statevector():
    rng = np.random.default_rng(0)
    for seed in range(8):
        n = int(rng.integers(2, 9))
        qc = random_clifford_circuit(n, 5, seed=seed)
        state = ts.StabilizerState.from_circuit(qc, device="cpu")
        psi = statevector(tensorize(qc), device="cpu")
        for _ in range(4):
            obs = PauliSum("".join(rng.choice(list("IXYZ"))
                                   for _ in range(n)))
            want = float(expval_pauli_sum(psi, obs))
            got = state.expectation(obs)
            assert got in (-1.0, 0.0, 1.0)
            assert abs(got - want) <= SV_TOL, (seed, obs)
    ghz = ts.StabilizerState.from_circuit(Circuit(3).h(0).cx(0, 1).cx(1, 2),
                                          device="cpu")
    assert ghz.expectation(PauliSum("ZZZ")) == 0.0
    assert ghz.expectation(PauliSum("XXX")) == 1.0
    assert ghz.expectation(PauliSum("ZZI")) == 1.0


def test_force_nonzero_and_random_clifford_match_jax():
    for seed in range(5):
        qc = random_clifford_circuit(4, 5, seed=seed)
        try:
            want = js.force_nonzero_expectation(_jax(qc))
        except UserWarning:
            with pytest.raises(UserWarning):
                ts.force_nonzero_expectation(qc, device="cpu")
            continue
        forced, expect = ts.force_nonzero_expectation(qc, device="cpu")
        assert forced.to_dict() == want[0].to_dict() and expect == want[1]
        psi = statevector(tensorize(forced), device="cpu")
        assert abs(float(expval_pauli_sum(psi, all_z(4))) - expect) <= SV_TOL
        got = ts.construct_random_clifford(4, 5, seed=seed, device="cpu")
        want = js.construct_random_clifford(4, 5, seed=seed)
        assert got[0].to_dict() == want[0].to_dict() and got[1] == want[1]


@pytest.mark.parametrize("n", [2, 3, 5])
def test_clifford_inverse_composes_to_identity(n):
    qc = random_clifford_circuit(n, 6, seed=n)
    both = qc.compose(ts.clifford_inverse_circuit(qc))
    psi = statevector(tensorize(both), device="cpu").numpy()
    assert abs(abs(psi[0]) - 1.0) <= SV_TOL
    tab = ts.StabilizerState.from_circuit(both, device="cpu").tab
    for g, w in zip(tab, ts.zero_tableau(n, device="cpu")):
        assert torch.equal(g, w)


def test_wide_composed_clifford_matches_jax():
    """100 qubits, the scalability sweep's block structure: one layer of
    primitives spans many blocks."""
    circuits = [generate_composed_clifford(5, 20, 3, seed=s)
                for s in range(3)]
    obs = "I" * 96 + "ZIIZ"
    np.testing.assert_array_equal(
        ts.batch_expectations(circuits, PauliSum(obs), device="cpu"),
        js.batch_expectations([_jax(c) for c in circuits], JPauliSum(obs)))
