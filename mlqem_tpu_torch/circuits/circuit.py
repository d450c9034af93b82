"""Circuit IR: a lightweight, tensorizable quantum-circuit representation.

Host-side (numpy) counterpart of ``mlqem_tpu/circuits/circuit.py``: a
circuit *batch* is one set of padded arrays
``(gate_ids[B, L], qubits[B, L, 2], params[B, L, 3])``, which the torch
simulators run as one batch.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .gates import GATE_IDS, GATE_NUM_QUBITS, is_structural


@dataclasses.dataclass(frozen=True)
class Op:
    """A single circuit operation."""

    name: str
    qubits: Tuple[int, ...]
    params: Tuple[float, ...] = ()

    def __post_init__(self):
        if self.name not in GATE_IDS:
            raise ValueError(f"unknown gate {self.name!r}")


class Circuit:
    """Mutable circuit builder with qiskit-like method sugar.

    Example::

        qc = Circuit(4)
        qc.h(0); qc.cx(0, 1); qc.rz(0.3, 2)
        qc.measure_all()
    """

    def __init__(self, num_qubits: int, metadata: Optional[dict] = None):
        self.num_qubits = int(num_qubits)
        self.ops: List[Op] = []
        self.metadata = metadata or {}

    # -- generic append ----------------------------------------------------
    def append(self, name: str, qubits, params=()) -> "Circuit":
        if isinstance(qubits, (int, np.integer)):
            qubits = (int(qubits),)
        qubits = tuple(int(q) for q in qubits)
        # keep symbolic parameters (Parameter / ParameterExpression) as-is
        params = tuple(p if not isinstance(p, (int, float, np.floating,
                                               np.integer)) else float(p)
                       for p in params)
        nq = GATE_NUM_QUBITS.get(name, 1)
        if name not in ("barrier", "measure") and len(qubits) != nq:
            raise ValueError(f"{name} expects {nq} qubits, got {qubits}")
        for q in qubits:
            if not 0 <= q < self.num_qubits:
                raise ValueError(f"qubit {q} out of range [0,{self.num_qubits})")
        self.ops.append(Op(name, qubits, params))
        return self

    def __len__(self):
        return len(self.ops)

    def copy(self) -> "Circuit":
        out = Circuit(self.num_qubits, dict(self.metadata))
        out.ops = list(self.ops)
        return out

    def compose(self, other: "Circuit") -> "Circuit":
        """Return self followed by `other` (qubit counts must match)."""
        if other.num_qubits != self.num_qubits:
            raise ValueError("qubit count mismatch in compose")
        out = self.copy()
        out.ops.extend(other.ops)
        return out

    def inverse(self) -> "Circuit":
        """Adjoint circuit (structural ops dropped)."""
        from ..transpile.lower import invert_op  # local import, avoids cycle

        out = Circuit(self.num_qubits, dict(self.metadata))
        for op in reversed(self.ops):
            if is_structural(op.name):
                continue
            out.ops.append(invert_op(op))
        return out

    # -- sugar for common gates --------------------------------------------
    def _1q(self, name, q, *params):
        if isinstance(q, (list, tuple, range, np.ndarray)):
            for qi in q:
                self.append(name, (int(qi),), params)
            return self
        return self.append(name, (q,), params)

    def id(self, q): return self._1q("id", q)
    def x(self, q): return self._1q("x", q)
    def y(self, q): return self._1q("y", q)
    def z(self, q): return self._1q("z", q)
    def h(self, q): return self._1q("h", q)
    def s(self, q): return self._1q("s", q)
    def sdg(self, q): return self._1q("sdg", q)
    def t(self, q): return self._1q("t", q)
    def tdg(self, q): return self._1q("tdg", q)
    def sx(self, q): return self._1q("sx", q)
    def sxdg(self, q): return self._1q("sxdg", q)
    def rx(self, theta, q): return self._1q("rx", q, theta)
    def ry(self, theta, q): return self._1q("ry", q, theta)
    def rz(self, theta, q): return self._1q("rz", q, theta)
    def p(self, lam, q): return self._1q("p", q, lam)
    def u2(self, phi, lam, q): return self._1q("u2", q, phi, lam)
    def u3(self, theta, phi, lam, q): return self._1q("u3", q, theta, phi, lam)

    def cx(self, c, t): return self.append("cx", (c, t))
    def cy(self, c, t): return self.append("cy", (c, t))
    def cz(self, c, t): return self.append("cz", (c, t))
    def ch(self, c, t): return self.append("ch", (c, t))
    def swap(self, a, b): return self.append("swap", (a, b))
    def crz(self, theta, c, t): return self.append("crz", (c, t), (theta,))
    def cp(self, lam, c, t): return self.append("cp", (c, t), (lam,))
    def rzz(self, theta, a, b): return self.append("rzz", (a, b), (theta,))
    def rxx(self, theta, a, b): return self.append("rxx", (a, b), (theta,))
    def ryy(self, theta, a, b): return self.append("ryy", (a, b), (theta,))
    def ecr(self, a, b): return self.append("ecr", (a, b))
    def cu3(self, theta, phi, lam, c, t):
        return self.append("cu3", (c, t), (theta, phi, lam))

    def barrier(self, qubits=None):
        qs = tuple(range(self.num_qubits)) if qubits is None else tuple(qubits)
        self.ops.append(Op("barrier", qs))
        return self

    def measure(self, q):
        return self.append("measure", (q,))

    def measure_all(self):
        self.barrier()
        for q in range(self.num_qubits):
            self.measure(q)
        return self

    # -- introspection (feature-encoder support) ----------------------------
    def count_ops(self) -> dict:
        """Gate-name → count histogram (parity with qiskit ``count_ops``)."""
        out: dict = {}
        for op in self.ops:
            out[op.name] = out.get(op.name, 0) + 1
        return out

    def depth(self) -> int:
        """Circuit depth over non-structural ops (parity with qiskit)."""
        level = [0] * self.num_qubits
        d = 0
        for op in self.ops:
            if op.name in ("barrier",):
                continue
            lv = max(level[q] for q in op.qubits) + 1
            for q in op.qubits:
                level[q] = lv
            d = max(d, lv)
        return d

    def num_nonstructural_ops(self) -> int:
        return sum(1 for op in self.ops if not is_structural(op.name))

    def rotation_angles(self) -> np.ndarray:
        """Angles of rx/ry/rz ops (reference ``mlp.py:124-133`` semantics)."""
        return np.array(
            [op.params[0] for op in self.ops
             if op.name in ("rx", "ry", "rz") and len(op.qubits) == 1],
            dtype=np.float64,
        )

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "num_qubits": self.num_qubits,
            "ops": [[op.name, list(op.qubits), list(op.params)]
                    for op in self.ops],
            "metadata": self.metadata,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Circuit":
        qc = cls(d["num_qubits"], d.get("metadata") or {})
        for name, qubits, params in d["ops"]:
            qc.ops.append(Op(name, tuple(qubits), tuple(params)))
        return qc

    def draw(self, max_width: int = 120) -> str:
        """ASCII rendering (qiskit ``draw('text')`` usability parity)."""
        from .drawing import draw

        return draw(self, max_width)

    def __repr__(self):
        return (f"<Circuit n={self.num_qubits} ops={len(self.ops)} "
                f"depth={self.depth()}>")


# ---------------------------------------------------------------------------
# Tensorization
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CircuitTensor:
    """Tensorized circuit batch: the simulator's input format.

    Attributes:
        gate_ids: int32[..., L] gate id per op slot (0 = NOP padding).
        qubits:   int32[..., L, 2] operand qubits (1q ops: second = partner).
        params:   float32[..., L, 3] gate parameters.
        num_qubits: int.
    Leading dims are batch dims. ``gate_ids`` and ``qubits`` are host
    numpy arrays; ``params`` is numpy, or a torch tensor on the simulator's
    device after :meth:`CircuitTemplate.bind`.
    """

    gate_ids: np.ndarray
    qubits: np.ndarray
    params: np.ndarray
    num_qubits: int

    @property
    def max_ops(self) -> int:
        return self.gate_ids.shape[-1]


def tensorize(circuit: Circuit, max_ops: Optional[int] = None) -> CircuitTensor:
    """Convert one circuit into padded arrays.

    Structural ops (measure/barrier/delay) are dropped — the simulators treat
    measurement at the sampling stage; feature encoders use the ``Circuit``
    object directly.
    """
    ops = [op for op in circuit.ops if not is_structural(op.name)]
    n = len(ops)
    L = max_ops if max_ops is not None else max(n, 1)
    if n > L:
        raise ValueError(f"circuit has {n} ops > max_ops={L}")
    # simulators pad 1-qubit circuits to 2 so the uniform 4x4 path works
    nq_eff = max(circuit.num_qubits, 2)
    gate_ids = np.zeros(L, dtype=np.int32)
    qubits = np.zeros((L, 2), dtype=np.int32)
    qubits[:, 1] = 1  # distinct padding partner so (a != b) always holds
    params = np.zeros((L, 3), dtype=np.float32)
    for i, op in enumerate(ops):
        gate_ids[i] = GATE_IDS[op.name]
        a = op.qubits[0]
        if len(op.qubits) >= 2:
            b = op.qubits[1]
        else:  # partner for the uniform 4x4 embedding
            b = (a + 1) % nq_eff
        qubits[i] = (a, b)
        for j, pval in enumerate(op.params[:3]):
            params[i, j] = pval
    return CircuitTensor(gate_ids, qubits, params, circuit.num_qubits)


def stack_circuits(circuits: Sequence[Circuit],
                   max_ops: Optional[int] = None) -> CircuitTensor:
    """Tensorize a batch of same-width circuits with shared padding."""
    if not circuits:
        raise ValueError("empty circuit list")
    n_qubits = circuits[0].num_qubits
    for c in circuits:
        if c.num_qubits != n_qubits:
            raise ValueError("all circuits in a batch must have equal width")
    if max_ops is None:
        max_ops = max(max(c.num_nonstructural_ops() for c in circuits), 1)
    ts = [tensorize(c, max_ops) for c in circuits]
    return CircuitTensor(
        np.stack([t.gate_ids for t in ts]),
        np.stack([t.qubits for t in ts]),
        np.stack([t.params for t in ts]),
        n_qubits,
    )


def pad_pow2_bucket(n_ops: int, min_bucket: int = 16) -> int:
    """Round op count up to a power-of-two bucket to bound recompiles."""
    b = min_bucket
    while b < n_ops:
        b *= 2
    return b
