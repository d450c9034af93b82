"""Pauli-twirled noise tables (host numpy).

A noise channel is projected onto its Pauli-twirled form: a Pauli channel
whose probabilities are the Walsh–Hadamard transform of the channel's
Pauli-transfer-matrix diagonal. The kicked-Ising engine samples one of the
16 two-qubit Paulis after every CX from these tables.
"""
from __future__ import annotations

import numpy as np

from .channels import Channel

# the 16 two-qubit Paulis in (a=MSB, b=LSB) order: index = 4*pa + pb
_P1 = [np.eye(2), np.array([[0, 1], [1, 0]]),
       np.array([[0, -1j], [1j, 0]]), np.diag([1, -1])]
PAULI_4X4 = np.stack([np.kron(_P1[a], _P1[b])
                      for a in range(4) for b in range(4)]).astype(
    np.complex64)


def _walsh() -> np.ndarray:
    w = np.zeros((16, 16), np.float32)

    def masks(i):
        a, b = divmod(i, 4)
        return (a in (1, 2), a in (2, 3), b in (1, 2), b in (2, 3))

    for qi in range(16):
        xq = masks(qi)
        for pi in range(16):
            xp = masks(pi)
            # symplectic product per qubit
            s = (xq[0] & xp[1]) ^ (xq[1] & xp[0]) \
                ^ (xq[2] & xp[3]) ^ (xq[3] & xp[2])
            w[qi, pi] = -1.0 if s else 1.0
    w.flags.writeable = False
    return w


_WALSH = _walsh()


def walsh_sign_matrix() -> np.ndarray:
    """w[P, Q] = ±1 commutation signs over the 16 2q Paulis (read-only).

    Pauli-channel composition is multiplication in this basis:
    f = w @ p are the channel's Pauli fidelities, and applying the channel
    k times gives probabilities p_k = (w @ f^k) / 16 (w·w = 16·I).
    """
    return _WALSH


def compose_pauli_channel(probs: np.ndarray, k: int) -> np.ndarray:
    """k-fold self-composition of a 2q Pauli channel (Walsh domain)."""
    w = walsh_sign_matrix()
    f = w @ probs
    p = (w @ (f ** k)) / 16.0
    p = np.clip(p, 0.0, None)
    s = p.sum()
    return p / s if s > 0 else p


def pauli_channel_probs(channel: Channel) -> np.ndarray:
    """Pauli-twirled probabilities p[16] of a 2q channel.

    p_Q = (1/16) Σ_P w(Q,P) · R_P with R_P = tr(P E(P))/4 the PTM diagonal
    and w(Q,P) = ±1 for commuting/anticommuting Pauli pairs.
    """
    ch = channel.expand_to_2q(0) if channel.dim == 2 else channel
    R = np.zeros(16)
    for i, P in enumerate(PAULI_4X4):
        acc = np.zeros((4, 4), dtype=np.complex128)
        for K in ch.kraus:
            acc += K @ P @ np.conj(K.T)
        R[i] = np.real(np.trace(P @ acc)) / 4.0
    p = (walsh_sign_matrix().astype(np.float64) @ R) / 16.0
    p = np.clip(p, 0.0, None)
    s = p.sum()
    if s > 0:
        p = p / s
    return p
