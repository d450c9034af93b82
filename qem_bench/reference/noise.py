"""The noise of a kicked-Ising circuit, worked out from calibration numbers.

Each CX carries the Pauli twirl of (depolarizing, then thermal relaxation on
both qubits), the depolarizing strength solved so that the pair reaches the
calibrated gate error (qiskit-aer's ``NoiseModel.from_backend``
semantics). The twirl is read from the channel's Pauli-transfer diagonal in
closed form: relaxation keeps X and Y by exp(−t/T2) and Z by exp(−t/T1),
depolarizing keeps every non-identity Pauli by 1 − p. Readout is a
symmetric flip of probability ``p``: ⟨Z⟩ is read as (1 − 2p)·⟨Z⟩.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# Pauli code 0..3 = I, X, Y, Z; a two-qubit Pauli is 4·p_control + p_target
X_BIT = np.array([0, 1, 1, 0])
Z_BIT = np.array([0, 0, 1, 1])


def commute_signs() -> np.ndarray:
    """s[Q, P] = +1 where the two-qubit Paulis Q and P commute, else −1."""
    s = np.empty((16, 16))
    for q in range(16):
        for p in range(16):
            odd = 0
            for qa, pa in ((q // 4, p // 4), (q % 4, p % 4)):
                odd ^= (X_BIT[qa] & Z_BIT[pa]) ^ (Z_BIT[qa] & X_BIT[pa])
            s[q, p] = -1.0 if odd else 1.0
    return s


def cx_pauli_probs(cal: Dict, a: int, b: int, scale: float = 1.0
                   ) -> np.ndarray:
    """float64 [16]: the twirled Pauli probabilities after CX(a → b)."""
    err, length = cal["cx"][(a, b)]
    t = length * scale

    def keep(q):
        t2 = np.exp(-t / cal["t2"][q])
        return np.array([1.0, t2, t2, np.exp(-t / cal["t1"][q])])

    ptm = np.outer(keep(a), keep(b)).reshape(16)
    f_relax = ptm.mean()
    e = min(err * scale, 1.0 - 4.0 ** -2)
    f_target = (5.0 * (1.0 - e) - 1.0) / 4.0
    p = 0.0
    if e > 0 and f_relax - 1.0 / 16.0 > 0:
        p = float(np.clip((f_relax - f_target) / (f_relax - 1.0 / 16.0),
                          0.0, 1.0))
    ptm[1:] *= 1.0 - p
    probs = np.clip(commute_signs() @ ptm / 16.0, 0.0, None)
    return probs / probs.sum()


def readout_scale(cal: Dict, q: int, scale: float = 1.0) -> float:
    """a in ⟨Z⟩_read = a·⟨Z⟩: 1 − 2p, p the scaled flip probability."""
    return 1.0 - 2.0 * min(cal["readout_error"][q] * scale, 0.5)


def window_bonds(start: int, w: int, nq: int
                 ) -> Tuple[list, list]:
    """The chain's bonds inside qubits [start, start + w), in the order a
    Trotter step applies them (the even bonds, then the odd): their local
    (control, target) pairs and their global control qubits."""
    glob = [a for par in (0, 1) for a in range(par, nq - 1, 2)
            if start <= a and a + 1 < start + w]
    return [(a - start, a + 1 - start) for a in glob], glob
