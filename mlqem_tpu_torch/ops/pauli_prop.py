"""Host-side local 2q Pauli algebra (numpy).

The lookup helpers of ``mlqem_tpu/ops/pauli_prop.py:41-56`` that the Pauli
frame engine (:mod:`.frame_trajectory`) builds its Clifford conjugation
tables from. Local code per qubit: 0=I, 1=X, 2=Y, 3=Z; 2q code =
4·code_a + code_b. The sparse Pauli-propagation engine itself is not
ported yet.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

_P1 = [np.eye(2), np.array([[0, 1], [1, 0]]),
       np.array([[0, -1j], [1j, 0]]), np.diag([1, -1])]


def _code_mat(c2: int) -> np.ndarray:
    """The 4x4 matrix of 2q Pauli code c2 (a = MSB)."""
    a, b = divmod(c2, 4)
    return np.kron(_P1[a], _P1[b])


def _find_code_sign(m: np.ndarray) -> Tuple[int, complex]:
    """(code, phase) with m = phase · _code_mat(code); raises if m is not
    a Pauli up to a phase in {±1, ±i}."""
    for c in range(16):
        ref = _code_mat(c)
        for sign in (1, -1, 1j, -1j):
            if np.allclose(m, sign * ref, atol=1e-9):
                return c, sign
    raise ValueError("not a Pauli")
