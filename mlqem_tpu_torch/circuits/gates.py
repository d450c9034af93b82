"""Gate vocabulary and unitary constructors.

The gate set covers the reference vocabulary
(``blackwater/data/utils.py:19-49`` ``available_gate_names``) plus the
hardware basis gates used by the experiment layer (``sx``, ``ecr`` — see
``docs/tutorials/mlp.py:148`` ``encode_data_v2_ecr``) and structural ops
(measure / barrier / delay / reset).

Everything here is designed for *tensorized* circuits: a circuit is a set of
arrays ``(gate_ids, qubits, params)`` and the per-op unitaries for a whole
circuit are materialized vectorized.

Conventions
-----------
* Qubit 0 is the least-significant bit of a computational-basis index
  (little-endian, matching qiskit / the reference).
* A two-qubit gate matrix is 4x4 indexed by ``m = 2*v_a + v_b`` where ``a``
  is the *first* operand (e.g. the control of CX) and ``b`` the second.
* One-qubit gates are embedded as ``U ⊗ I`` acting on ``(a, partner)`` so the
  simulator has a single uniform 4x4 code path (branch-free scan).
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Gate ids. NOP (padding) must be 0.
# ---------------------------------------------------------------------------
GATE_NAMES = [
    "nop",      # 0: padding
    "id",       # 1
    "x",        # 2
    "y",        # 3
    "z",        # 4
    "h",        # 5
    "s",        # 6
    "sdg",      # 7
    "t",        # 8
    "tdg",      # 9
    "sx",       # 10
    "sxdg",     # 11
    "rx",       # 12: rx(theta)
    "ry",       # 13: ry(theta)
    "rz",       # 14: rz(theta)
    "p",        # 15: phase(lambda) == u1
    "u2",       # 16: u2(phi, lambda)
    "u3",       # 17: u3(theta, phi, lambda) == u
    "cx",       # 18
    "cy",       # 19
    "cz",       # 20
    "ch",       # 21
    "swap",     # 22
    "crz",      # 23: crz(theta)
    "cp",       # 24: cphase(lambda) == cu1
    "rzz",      # 25: rzz(theta)
    "rxx",      # 26: rxx(theta)
    "ryy",      # 27: ryy(theta)
    "ecr",      # 28
    "cu3",      # 29: cu3(theta, phi, lambda)
    "measure",  # 30: structural (no-op for unitary evolution)
    "barrier",  # 31: structural
    "delay",    # 32: structural
    "reset",    # 33: structural (simulators handle explicitly)
]

GATE_IDS = {name: i for i, name in enumerate(GATE_NAMES)}
NUM_GATE_KINDS = len(GATE_NAMES)

# Number of qubit operands per gate (structural ops treated as 1q no-ops).
GATE_NUM_QUBITS = {
    **{g: 1 for g in GATE_NAMES},
    **{g: 2 for g in ["cx", "cy", "cz", "ch", "swap", "crz", "cp",
                      "rzz", "rxx", "ryy", "ecr", "cu3"]},
}

# Number of float parameters per gate.
GATE_NUM_PARAMS = {
    **{g: 0 for g in GATE_NAMES},
    "rx": 1, "ry": 1, "rz": 1, "p": 1, "u2": 2, "u3": 3,
    "crz": 1, "cp": 1, "rzz": 1, "rxx": 1, "ryy": 1, "cu3": 3,
    "delay": 1,
}

# Gates with a rotation-angle first parameter (used by the angle-histogram
# feature encoder, reference ``mlp.py:124-133`` counts rx/ry/rz only).
ROTATION_GATES = ("rx", "ry", "rz")

# Reference's 26-name vocabulary (``data/utils.py:19-49``) for encoders that
# need exactly that ordering (u1 == p, cu1 == cp there).
REFERENCE_VOCAB = [
    "id", "u1", "u2", "u3", "x", "y", "z", "h", "s", "sdg", "t", "tdg",
    "rx", "ry", "rz",
    "cx", "cy", "cz", "ch", "crz", "cu1", "cu3", "swap", "rzz",
    "ccx", "cswap",
]

_STRUCTURAL = frozenset({"measure", "barrier", "delay", "reset", "nop"})


def is_structural(name: str) -> bool:
    return name in _STRUCTURAL


# ---------------------------------------------------------------------------
# Dense unitary constructors (numpy, used for tests / tensorization tables).
# ---------------------------------------------------------------------------
_I2 = np.eye(2, dtype=np.complex128)
_X = np.array([[0, 1], [1, 0]], dtype=np.complex128)
_Y = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
_Z = np.array([[1, 0], [0, -1]], dtype=np.complex128)
_H = np.array([[1, 1], [1, -1]], dtype=np.complex128) / np.sqrt(2)


def _u3(theta, phi, lam):
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return np.array(
        [[c, -np.exp(1j * lam) * s],
         [np.exp(1j * phi) * s, np.exp(1j * (phi + lam)) * c]],
        dtype=np.complex128,
    )


def _controlled(u):
    """|0><0| ⊗ I + |1><1| ⊗ U in the (a=MSB, b=LSB) local convention."""
    out = np.eye(4, dtype=np.complex128)
    out[2:, 2:] = u
    return out


def gate_unitary(name: str, params=()) -> np.ndarray:
    """Dense unitary for a gate: 2x2 for 1q, 4x4 for 2q ops.

    Local 2q index convention: m = 2*v_first + v_second.
    """
    p = list(params) + [0.0] * 3
    t, f, l = p[0], p[1], p[2]
    if name in ("id", "measure", "barrier", "delay", "nop", "reset"):
        return _I2.copy()
    if name == "x":
        return _X.copy()
    if name == "y":
        return _Y.copy()
    if name == "z":
        return _Z.copy()
    if name == "h":
        return _H.copy()
    if name == "s":
        return np.diag([1, 1j]).astype(np.complex128)
    if name == "sdg":
        return np.diag([1, -1j]).astype(np.complex128)
    if name == "t":
        return np.diag([1, np.exp(1j * np.pi / 4)]).astype(np.complex128)
    if name == "tdg":
        return np.diag([1, np.exp(-1j * np.pi / 4)]).astype(np.complex128)
    if name == "sx":
        return 0.5 * np.array([[1 + 1j, 1 - 1j], [1 - 1j, 1 + 1j]])
    if name == "sxdg":
        return 0.5 * np.array([[1 - 1j, 1 + 1j], [1 + 1j, 1 - 1j]])
    if name == "rx":
        return _u3(t, -np.pi / 2, np.pi / 2)
    if name == "ry":
        return _u3(t, 0.0, 0.0)
    if name == "rz":
        return np.diag([np.exp(-1j * t / 2), np.exp(1j * t / 2)])
    if name == "p":
        return np.diag([1.0, np.exp(1j * t)])
    if name == "u2":
        return _u3(np.pi / 2, t, f)
    if name == "u3":
        return _u3(t, f, l)
    if name == "cx":
        return _controlled(_X)
    if name == "cy":
        return _controlled(_Y)
    if name == "cz":
        return _controlled(_Z)
    if name == "ch":
        return _controlled(_H)
    if name == "swap":
        return np.array(
            [[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
            dtype=np.complex128,
        )
    if name == "crz":
        return _controlled(gate_unitary("rz", [t]))
    if name == "cp":
        return _controlled(gate_unitary("p", [t]))
    if name == "rzz":
        # exp(-i t/2 Z⊗Z)
        e = np.exp(-1j * t / 2)
        ec = np.exp(1j * t / 2)
        return np.diag([e, ec, ec, e])
    if name == "rxx":
        c, s = np.cos(t / 2), -1j * np.sin(t / 2)
        out = np.eye(4, dtype=np.complex128) * c
        out[0, 3] = out[3, 0] = out[1, 2] = out[2, 1] = s
        return out
    if name == "ryy":
        c, s = np.cos(t / 2), 1j * np.sin(t / 2)
        out = np.eye(4, dtype=np.complex128) * c
        out[0, 3] = out[3, 0] = s
        out[1, 2] = out[2, 1] = -s
        return out
    if name == "ecr":
        # qiskit ECRGate: 1/sqrt(2) (IX - XY) in qiskit's little-endian label
        # order, where the label's RIGHTMOST letter acts on the FIRST qarg.
        # So ECR(a, b) puts X (resp. Y) on a and I (resp. X) on b. In our
        # a=MSB kron convention: ECR = 1/sqrt(2) (X_a⊗I_b - Y_a⊗X_b), equal
        # to rzx(pi/4)·x(a)·rzx(-pi/4) (cross-checked against the stabilizer
        # and transpiler decompositions in tests/test_transpile_qasm.py).
        return (np.kron(_X, _I2) - np.kron(_Y, _X)) / np.sqrt(2)
    if name == "cu3":
        return _controlled(_u3(t, f, l))
    raise ValueError(f"unknown gate {name!r}")


def gate_unitary_4x4(name: str, params=()) -> np.ndarray:
    """Uniform 4x4 embedding: 1q gates become U ⊗ I (first operand = MSB)."""
    u = gate_unitary(name, params)
    if u.shape == (2, 2):
        return np.kron(u, _I2)
    return u
