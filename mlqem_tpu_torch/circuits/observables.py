"""Pauli-sum observables.

Replaces qiskit ``PauliSumOp`` / ``SparsePauliOp`` in the reference API
(``blackwater/data/utils.py:447-491``). Conventions match qiskit: a Pauli
string reads left→right from the highest qubit to qubit 0 (little-endian
indices, big-endian string).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple, Union

import numpy as np

# per-qubit codes
_I, _X, _Y, _Z = 0, 1, 2, 3
_CODE = {"I": _I, "X": _X, "Y": _Y, "Z": _Z}
_CHAR = "IXYZ"


@dataclasses.dataclass(frozen=True)
class PauliTerm:
    """A single Pauli string with coefficient."""

    pauli: str
    coeff: complex = 1.0

    @property
    def num_qubits(self) -> int:
        return len(self.pauli)

    def codes(self) -> np.ndarray:
        """int8[n] per-qubit code, index q = qubit q (little-endian)."""
        return np.array([_CODE[c] for c in reversed(self.pauli)], dtype=np.int8)

    def masks(self) -> Tuple[int, int]:
        """(x_mask, z_mask) bitmasks over qubits: X→x, Z→z, Y→both."""
        x = z = 0
        for q, c in enumerate(reversed(self.pauli)):
            if c in ("X", "Y"):
                x |= 1 << q
            if c in ("Z", "Y"):
                z |= 1 << q
        return x, z


class PauliSum:
    """Weighted sum of Pauli strings.

    Construct from a list of ``(string, coeff)`` pairs, a bare string, or use
    :meth:`from_list` for qiskit-``SparsePauliOp.from_list`` parity.
    """

    def __init__(self, terms: Union[str, Sequence]):
        if isinstance(terms, str):
            terms = [(terms, 1.0)]
        parsed: List[PauliTerm] = []
        for t in terms:
            if isinstance(t, PauliTerm):
                parsed.append(t)
            elif isinstance(t, str):
                parsed.append(PauliTerm(t, 1.0))
            else:
                s, c = t
                parsed.append(PauliTerm(s, complex(c)))
        if not parsed:
            raise ValueError("PauliSum needs at least one term")
        n = parsed[0].num_qubits
        for t in parsed:
            if t.num_qubits != n:
                raise ValueError("all Pauli terms must have equal width")
            if any(ch not in _CODE for ch in t.pauli):
                raise ValueError(f"bad Pauli string {t.pauli!r}")
        self.terms = parsed
        self.num_qubits = n

    @classmethod
    def from_list(cls, pairs: Sequence[Tuple[str, complex]]) -> "PauliSum":
        return cls(list(pairs))

    def to_list(self) -> List[Tuple[str, complex]]:
        return [(t.pauli, t.coeff) for t in self.terms]

    def __len__(self):
        return len(self.terms)

    def __iter__(self):
        return iter(self.terms)

    def __repr__(self):
        return f"PauliSum({self.to_list()!r})"

    # -- tensor forms --------------------------------------------------------
    def code_matrix(self) -> np.ndarray:
        """int8[T, n] per-term per-qubit codes (qubit q at column q)."""
        return np.stack([t.codes() for t in self.terms])

    def coeffs(self) -> np.ndarray:
        return np.array([t.coeff for t in self.terms], dtype=np.complex128)

    def masks(self) -> Tuple[np.ndarray, np.ndarray]:
        """(x_masks[T], z_masks[T]) uint32 bitmask arrays."""
        xs, zs = zip(*(t.masks() for t in self.terms))
        return (np.array(xs, dtype=np.uint32), np.array(zs, dtype=np.uint32))

    def is_diagonal(self) -> bool:
        """True if every term is I/Z-only (diagonal in the Z basis)."""
        return all(set(t.pauli) <= {"I", "Z"} for t in self.terms)

    def to_matrix(self) -> np.ndarray:
        """Dense matrix (tests only — exponential in qubit count)."""
        mats = {
            "I": np.eye(2), "X": np.array([[0, 1], [1, 0]]),
            "Y": np.array([[0, -1j], [1j, 0]]), "Z": np.diag([1, -1]),
        }
        dim = 2 ** self.num_qubits
        out = np.zeros((dim, dim), dtype=np.complex128)
        for t in self.terms:
            m = np.array([[1.0]])
            for ch in t.pauli:  # leftmost char = highest qubit
                m = np.kron(m, mats[ch])
            out += t.coeff * m
        return out


def single_z(qubit: int, num_qubits: int, coeff: float = 1.0) -> PauliSum:
    """⟨Z_q⟩ observable (the workhorse of the MBL / Ising experiments)."""
    s = ["I"] * num_qubits
    s[num_qubits - 1 - qubit] = "Z"
    return PauliSum([("".join(s), coeff)])


def all_z(num_qubits: int, coeff: float = 1.0) -> PauliSum:
    """Global Z⊗…⊗Z (reference ``cal_all_z_exp`` target)."""
    return PauliSum([("Z" * num_qubits, coeff)])


def random_pauli_sum(num_qubits: int, size: int, coeff=None,
                     seed=None) -> PauliSum:
    """Random Pauli-sum generator.

    Parity with ``generate_random_pauli_sum_op``
    (``blackwater/data/utils.py:477-491``): uniform random strings, uniform
    coefficients in [-1, 1] unless fixed.
    """
    rng = np.random.default_rng(seed)
    terms = []
    for _ in range(size):
        s = "".join(rng.choice(list("IXYZ")) for _ in range(num_qubits))
        c = float(coeff) if coeff is not None else float(rng.uniform(-1, 1))
        terms.append((s, c))
    return PauliSum(terms)
