"""Pauli twirling of two-qubit gates.

Replaces the IBM-internal ``pec_runtime`` twirling the reference's 100Q
hardware pipeline uses (``h31_submit_zne_hardware_100q_twirl.ipynb``:
``stratify_circuit_into_layers`` + ``TwirledCircuit.sample_circuits``):
each 2q Clifford gate G is conjugated by uniform random Pauli pairs,
G → (Q_a⊗Q_b)·G·(P_a⊗P_b) with Q = G P G† (± sign is a global phase),
converting coherent errors into stochastic Pauli noise. Twirl instances
share circuit topology, so a whole twirl ensemble is one batched sim call.
Counterpart of ``mlqem_tpu/mitigation/twirling.py``: host numpy with the
same seeded draws, so a seed gives the same circuits in both packages.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..circuits.circuit import Circuit, Op
from ..circuits.gates import gate_unitary

_PAULI_NAMES = ["id", "x", "y", "z"]
_PAULI_MATS = [gate_unitary(n) for n in _PAULI_NAMES]

_TWIRL_TABLES: Dict[str, List[Tuple[int, int]]] = {}


def _conjugation_table(gate: str) -> List[Tuple[int, int]]:
    """For each pre-pair index (4·a + b): the post-pair (qa, qb) with
    G·(P_a⊗P_b)·G† = ±(Q_a⊗Q_b)."""
    from ..circuits.gates import GATE_NUM_PARAMS

    if GATE_NUM_PARAMS.get(gate, 0) != 0:
        raise ValueError(f"cannot twirl parameterized gate {gate!r} — only "
                         "fixed Clifford 2q gates normalize the Pauli group")
    g = gate_unitary(gate)
    if g.shape != (4, 4):
        raise ValueError(f"{gate} is not a two-qubit gate")
    table = []
    for a in range(4):
        for b in range(4):
            p = np.kron(_PAULI_MATS[a], _PAULI_MATS[b])
            q = g @ p @ np.conj(g.T)
            found = None
            for qa in range(4):
                for qb in range(4):
                    cand = np.kron(_PAULI_MATS[qa], _PAULI_MATS[qb])
                    for sign in (1, -1, 1j, -1j):
                        if np.allclose(q, sign * cand, atol=1e-8):
                            found = (qa, qb)
                            break
                    if found:
                        break
                if found:
                    break
            if found is None:
                raise ValueError(f"{gate} does not normalize the Pauli group"
                                 " — cannot twirl a non-Clifford gate")
            table.append(found)
    return table


def twirl_table(gate: str) -> List[Tuple[int, int]]:
    if gate not in _TWIRL_TABLES:
        _TWIRL_TABLES[gate] = _conjugation_table(gate)
    return _TWIRL_TABLES[gate]


def _apply_twirl_codes(circuit: Circuit, codes: Sequence[int],
                       gates: Sequence[str]) -> Circuit:
    """Build one twirl instance from explicit pre-pair codes (4·pa + pb),
    one per eligible 2q gate in circuit order."""
    out = Circuit(circuit.num_qubits, dict(circuit.metadata))
    it = iter(codes)
    for op in circuit.ops:
        if op.name in gates and len(op.qubits) == 2:
            a, b = op.qubits
            code = int(next(it))
            pa, pb = code // 4, code % 4
            qa, qb = twirl_table(op.name)[code]
            if pa:
                out.ops.append(Op(_PAULI_NAMES[pa], (a,), ()))
            if pb:
                out.ops.append(Op(_PAULI_NAMES[pb], (b,), ()))
            out.ops.append(op)
            if qa:
                out.ops.append(Op(_PAULI_NAMES[qa], (a,), ()))
            if qb:
                out.ops.append(Op(_PAULI_NAMES[qb], (b,), ()))
        else:
            out.ops.append(op)
    return out


def _count_eligible(circuit: Circuit, gates: Sequence[str]) -> int:
    return sum(1 for op in circuit.ops
               if op.name in gates and len(op.qubits) == 2)


def twirl_circuit(circuit: Circuit, seed: Optional[int] = None,
                  gates: Sequence[str] = ("cx", "cz", "ecr")) -> Circuit:
    """One random twirl instance: sandwich each eligible 2q gate in random
    Paulis that preserve its action."""
    rng = np.random.default_rng(seed)
    n = _count_eligible(circuit, gates)
    return _apply_twirl_codes(circuit, rng.integers(16, size=n), gates)


def sample_twirled_circuits(circuit: Circuit, num_twirls: int,
                            seed: int = 0,
                            gates: Sequence[str] = ("cx", "cz", "ecr"),
                            balanced: bool = True) -> List[Circuit]:
    """``TwirledCircuit.sample_circuits(num_twirl)`` parity: twirl
    instances of one circuit (averaging their expvals estimates the
    Pauli-twirled channel).

    ``balanced`` stratifies the ensemble so each gate sees every one of
    its 16 Pauli pairs as equally often as num_twirls allows
    (independently shuffled per gate): with num_twirls a multiple of 16
    the single-gate marginals are EXACTLY uniform; otherwise the
    remainder codes are a uniformly random subset (unbiased marginals,
    small residual variance). Either way the first-order coherent-error
    terms that dominate plain-MC variance cancel ~θ× faster.
    """
    rng = np.random.default_rng(seed)
    n = _count_eligible(circuit, gates)
    if not balanced:
        return [_apply_twirl_codes(circuit, rng.integers(16, size=n), gates)
                for _ in range(num_twirls)]

    def one_gate_codes():
        # full 16-blocks + an unbiased random subset for the remainder
        # (a fixed arange slice would overweight the low codes — e.g. at
        # num_twirls=8 the control pre-Pauli would only ever be I or X)
        full = np.tile(np.arange(16), num_twirls // 16)
        rem = rng.choice(16, num_twirls % 16, replace=False)
        return rng.permutation(np.concatenate([full, rem]))

    # [n, T]: per-gate balanced multiset, independently shuffled
    assign = np.stack([one_gate_codes() for _ in range(n)]) \
        if n else np.zeros((0, num_twirls), np.int64)
    return [_apply_twirl_codes(circuit, assign[:, t], gates)
            for t in range(num_twirls)]


def twirl_average(values: np.ndarray, num_twirls: int) -> np.ndarray:
    """Average expvals over the twirl axis — the demo1 post-processing
    ``reshape(n, obs, num_twirl).mean(-1)`` step."""
    v = np.asarray(values)
    return v.reshape(-1, num_twirls).mean(axis=-1)
