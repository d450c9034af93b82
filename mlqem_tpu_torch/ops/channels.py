"""Quantum noise channels (Kraus / superoperator library).

Host-side (numpy) replacement for the qiskit-aer channel constructors the
reference uses to build its controlled fault-injection noise models
(``docs/tutorials/noise_utils.py:54-144``, ``mbd_utils.py:95-137``):
``depolarizing_error``, ``thermal_relaxation_error``,
``coherent_unitary_error``, ``mixed_unitary_error``, ``pauli_error``.

Channels are built host-side in numpy (they depend on static calibration
data) and compiled into a per-op 16x16 superoperator lookup table consumed by
the density-matrix engine. Superoperator convention: acting on a dm block
``G[p, q]`` flattened as ``k = 4p + q``, a unitary U has ``S = kron(U, U*)``
and a Kraus set ``S = Σ_k kron(K_k, K_k*)``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

_I2 = np.eye(2, dtype=np.complex128)
_PAULIS_1Q = [
    _I2,
    np.array([[0, 1], [1, 0]], dtype=np.complex128),
    np.array([[0, -1j], [1j, 0]], dtype=np.complex128),
    np.array([[1, 0], [0, -1]], dtype=np.complex128),
]


@dataclasses.dataclass
class Channel:
    """A CPTP map as a list of Kraus operators on 1 or 2 qubits."""

    kraus: List[np.ndarray]

    @property
    def dim(self) -> int:
        return self.kraus[0].shape[0]

    @property
    def num_qubits(self) -> int:
        return 1 if self.dim == 2 else 2

    def superop(self) -> np.ndarray:
        """Column-block superoperator: S = Σ_k kron(K_k, conj(K_k))."""
        d2 = self.dim ** 2
        s = np.zeros((d2, d2), dtype=np.complex128)
        for k in self.kraus:
            s += np.kron(k, np.conj(k))
        return s

    def compose(self, other: "Channel") -> "Channel":
        """Apply ``self`` first, then ``other`` (qiskit ``compose`` order)."""
        if other.dim != self.dim:
            raise ValueError("channel dims differ")
        return Channel([b @ a for a in self.kraus for b in other.kraus])

    def expand_to_2q(self, slot: int) -> "Channel":
        """Embed a 1q channel on local slot 0 (MSB) or 1 (LSB) of a 2q frame."""
        if self.dim == 4:
            return self
        if slot == 0:
            return Channel([np.kron(k, _I2) for k in self.kraus])
        return Channel([np.kron(_I2, k) for k in self.kraus])

    def is_trace_preserving(self, tol=1e-9) -> bool:
        acc = sum(np.conj(k.T) @ k for k in self.kraus)
        return bool(np.allclose(acc, np.eye(self.dim), atol=tol))

    def process_fidelity(self) -> float:
        """Process fidelity with the identity: Σ_k |tr K_k|² / d²."""
        d = self.dim
        return float(sum(abs(np.trace(k)) ** 2 for k in self.kraus) / d ** 2)

    def average_gate_fidelity(self) -> float:
        d = self.dim
        return (d * self.process_fidelity() + 1) / (d + 1)


def identity_channel(num_qubits: int = 1) -> Channel:
    return Channel([np.eye(2 ** num_qubits, dtype=np.complex128)])


def unitary_channel(u: np.ndarray) -> Channel:
    """Coherent error (``coherent_unitary_error`` parity)."""
    return Channel([np.asarray(u, dtype=np.complex128)])


def mixed_unitary_channel(pairs: Sequence) -> Channel:
    """Mixed-unitary channel from (unitary, prob) pairs."""
    return Channel([np.sqrt(p) * np.asarray(u, dtype=np.complex128)
                    for u, p in pairs])


def pauli_channel(pairs: Sequence) -> Channel:
    """``pauli_error`` parity: (pauli_string, prob) pairs, e.g. [("X", .1), ("I", .9)]."""
    kraus = []
    for s, p in pairs:
        m = np.array([[1.0]], dtype=np.complex128)
        for ch in s:  # leftmost char = first (MSB) qubit of the local frame
            m = np.kron(m, _PAULIS_1Q["IXYZ".index(ch)])
        kraus.append(np.sqrt(p) * m)
    return Channel(kraus)


def depolarizing_channel(p: float, num_qubits: int = 1) -> Channel:
    """qiskit ``depolarizing_error(p, n)`` parity.

    E(ρ) = (1 - p·(d²-1)/d²)ρ + (p/d²)·Σ_{P≠I} PρP.
    """
    d2 = 4 ** num_qubits
    paulis = _PAULIS_1Q if num_qubits == 1 else [
        np.kron(a, b) for a in _PAULIS_1Q for b in _PAULIS_1Q]
    w_id = 1.0 - p * (d2 - 1) / d2
    kraus = [np.sqrt(w_id) * paulis[0]]
    kraus += [np.sqrt(p / d2) * pl for pl in paulis[1:]]
    return Channel(kraus)


def thermal_relaxation_channel(t1: float, t2: float, time: float,
                               excited_state_population: float = 0.0
                               ) -> Channel:
    """``thermal_relaxation_error`` parity for the physical T2 ≤ 2·T1 regime.

    Kraus: amplitude damping γ = 1-e^{-t/T1} combined with dephasing chosen
    so coherences decay as e^{-t/T2}.
    """
    if time <= 0 or (t1 <= 0 and t2 <= 0):
        return identity_channel(1)
    gamma = 1 - np.exp(-time / t1) if t1 > 0 else 0.0
    decay = np.exp(-time / t2) if t2 > 0 else 1.0
    lam = 1 - gamma - decay ** 2
    lam = max(lam, 0.0)  # clip tiny negatives from calibration noise
    p1 = float(excited_state_population)
    if p1 == 0.0:
        k1 = np.array([[1, 0], [0, np.sqrt(max(1 - gamma - lam, 0.0))]],
                      dtype=np.complex128)
        k2 = np.array([[0, np.sqrt(gamma)], [0, 0]], dtype=np.complex128)
        k3 = np.array([[0, 0], [0, np.sqrt(lam)]], dtype=np.complex128)
        return Channel([k1, k2, k3])
    # finite-temperature generalization
    g_down, g_up = gamma * (1 - p1), gamma * p1
    k_rest = max(1 - g_down - g_up - lam, 0.0)
    ks = [
        np.diag([np.sqrt(1 - g_up), np.sqrt(k_rest + lam * 0)]),
        np.array([[0, np.sqrt(g_down)], [0, 0]]),
        np.array([[0, 0], [np.sqrt(g_up), 0]]),
        np.diag([0, np.sqrt(lam)]),
    ]
    return Channel([k.astype(np.complex128) for k in ks])


def amplitude_damping_channel(gamma: float) -> Channel:
    k1 = np.array([[1, 0], [0, np.sqrt(1 - gamma)]], dtype=np.complex128)
    k2 = np.array([[0, np.sqrt(gamma)], [0, 0]], dtype=np.complex128)
    return Channel([k1, k2])


def phase_damping_channel(lam: float) -> Channel:
    k1 = np.array([[1, 0], [0, np.sqrt(1 - lam)]], dtype=np.complex128)
    k2 = np.array([[0, 0], [0, np.sqrt(lam)]], dtype=np.complex128)
    return Channel([k1, k2])


def coherent_overrotation_cx(theta: float) -> Channel:
    """The paper's coherent CX over-rotation error (AddNoise parity).

    ``err = over_rotated_cnot @ CX`` where the over-rotated CNOT applies
    ``i·RX(π+θ)`` on the target conditioned on the control
    (``noise_utils.py:97-101``; at θ=0 the error is the identity).
    Local convention: control = MSB (first operand), target = LSB.
    """
    from ..circuits.gates import gate_unitary

    rx = gate_unitary("rx", (np.pi + theta,))
    over = np.zeros((4, 4), dtype=np.complex128)
    over[:2, :2] = _I2
    over[2:, 2:] = 1j * rx
    cx = gate_unitary("cx")
    return unitary_channel(over @ cx)


def depol_param_for_target_error(gate_error: float,
                                 relax_channel: Optional[Channel],
                                 num_qubits: int) -> float:
    """Depolarizing strength so (depol ∘ relax) hits a target gate error.

    Aer ``basic_device_gate_errors`` semantics: given calibration
    ``gate_error`` (average infidelity) and the thermal-relaxation channel for
    the gate duration, solve for p in
    ``(1-p)·F_pro(relax) + p/d² = F_pro(target)``.
    """
    d = 2 ** num_qubits
    f_avg_target = 1.0 - gate_error
    f_pro_target = ((d + 1) * f_avg_target - 1) / d
    f_pro_relax = relax_channel.process_fidelity() if relax_channel else 1.0
    denom = f_pro_relax - 1.0 / d ** 2
    if denom <= 0:
        return 0.0
    p = (f_pro_relax - f_pro_target) / denom
    return float(min(max(p, 0.0), 1.0))


def readout_confusion(p01: float, p10: Optional[float] = None) -> np.ndarray:
    """2x2 column-stochastic assignment matrix M[meas, true].

    ``p01`` = P(read 1 | prepared 0); ``p10`` = P(read 0 | prepared 1)
    (defaults symmetric, matching the single readout_error calibration value).
    """
    if p10 is None:
        p10 = p01
    return np.array([[1 - p01, p10], [p01, 1 - p10]], dtype=np.float64)
