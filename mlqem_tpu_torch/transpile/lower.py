"""Minimal transpiler: basis lowering + layout routing.

Host-side (numpy) counterpart of ``mlqem_tpu/transpile/lower.py``. The
reference leans on qiskit ``transpile`` for basis conversion
(``data/generators/exp_val.py:116-120``, ``learning/estimator.py:108-114``).
Gate-count distributions of the *transpiled* circuit are model features
(``mlp.py:172-189``), so the new framework needs its own lowering pass to the
IBM basis sets {cx|ecr, sx, x, rz, id}.

This is a deterministic structural pass (no retry loops needed — the
reference's LinAlgError retries, ``learning/estimator.py:108-114``, were
artifacts of qiskit's stochastic synthesis).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..circuits.circuit import Circuit, Op

_SELF_INVERSE = {"id", "x", "y", "z", "h", "cx", "cy", "cz", "ch", "swap",
                 "ecr"}
_DAGGER_PAIRS = {"s": "sdg", "sdg": "s", "t": "tdg", "tdg": "t",
                 "sx": "sxdg", "sxdg": "sx"}
_NEGATE_PARAM = {"rx", "ry", "rz", "p", "crz", "cp", "rzz", "rxx", "ryy"}


def invert_op(op: Op) -> Op:
    """Adjoint of a single op."""
    if op.name in _SELF_INVERSE:
        return op
    if op.name in _DAGGER_PAIRS:
        return Op(_DAGGER_PAIRS[op.name], op.qubits, op.params)
    if op.name in _NEGATE_PARAM:
        return Op(op.name, op.qubits, (-op.params[0],))
    if op.name == "u3":
        t, f, l = op.params
        return Op("u3", op.qubits, (-t, -l, -f))
    if op.name == "u2":
        f, l = op.params
        return Op("u3", op.qubits, (-math.pi / 2, -l, -f))
    if op.name == "cu3":
        t, f, l = op.params
        return Op("cu3", op.qubits, (-t, -l, -f))
    raise ValueError(f"cannot invert {op.name}")


# ---------------------------------------------------------------------------
# 1q synthesis: U(2) → rz · sx · rz · sx · rz   (IBM hardware basis)
# ---------------------------------------------------------------------------
def zxz_angles(u: np.ndarray) -> Tuple[float, float, float]:
    """Extract (theta, phi, lam) with U ~ u3(theta, phi, lam) up to phase."""
    # strip global phase so that u[0,0] is real >= 0
    det = np.linalg.det(u)
    u = u / np.sqrt(det)
    # u = [[cos(t/2) e^{-i(f+l)/2}, ...]] in this normalization
    a, b = u[0, 0], u[0, 1]
    c, d = u[1, 0], u[1, 1]
    theta = 2 * math.atan2(abs(c), abs(a))
    if abs(a) > 1e-12 and abs(c) > 1e-12:
        phi = float(np.angle(c) - np.angle(a))
        lam = float(np.angle(-b) - np.angle(a))
    elif abs(c) <= 1e-12:  # diagonal
        phi = float(np.angle(d) - np.angle(a))
        lam = 0.0
    else:  # anti-diagonal
        phi = float(np.angle(c) - np.angle(-b))
        lam = 0.0
        theta = math.pi
        phi = float(np.angle(c / (-b)))  # split arbitrarily
        lam = 0.0
        phi = float(np.angle(c) + np.angle(-1 / b)) if abs(b) > 1e-12 else 0.0
    return theta, phi, lam


def u3_to_basis_ops(theta: float, phi: float, lam: float,
                    q: int, tol: float = 1e-9) -> List[Op]:
    """u3(theta, phi, lam) → [rz, sx, rz, sx, rz] with short-circuit cases.

    Identity: u3(t,f,l) = rz(f+pi) sx rz(t+pi) sx rz(l)  (up to global phase).
    """
    theta = float(theta) % (4 * math.pi)
    ops: List[Op] = []

    def rz(angle):
        angle = float((angle + math.pi) % (2 * math.pi) - math.pi)
        if abs(angle) > tol:
            ops.append(Op("rz", (q,), (angle,)))

    # diagonal case
    if abs(math.sin(theta / 2)) < tol:
        extra = 0.0 if abs(math.cos(theta / 2) - 1) < tol else 2 * math.pi
        rz(phi + lam + extra)
        return ops
    # single-sx case: theta == pi/2
    if abs(theta - math.pi / 2) < tol:
        rz(lam - math.pi / 2)
        ops.append(Op("sx", (q,), ()))
        rz(phi + math.pi / 2)
        return ops
    rz(lam)
    ops.append(Op("sx", (q,), ()))
    rz(theta + math.pi)
    ops.append(Op("sx", (q,), ()))
    rz(phi + 3 * math.pi)
    return ops


_1Q_TO_U3: Dict[str, Tuple[float, float, float]] = {
    "x": (math.pi, 0.0, math.pi),
    "y": (math.pi, math.pi / 2, math.pi / 2),
    "z": (0.0, 0.0, math.pi),
    "h": (math.pi / 2, 0.0, math.pi),
    "s": (0.0, 0.0, math.pi / 2),
    "sdg": (0.0, 0.0, -math.pi / 2),
    "t": (0.0, 0.0, math.pi / 4),
    "tdg": (0.0, 0.0, -math.pi / 4),
    "sxdg": (math.pi / 2, math.pi, 0.0),  # handled specially below
}


def _lower_1q(op: Op, basis_has_x: bool = True) -> List[Op]:
    """Lower a 1q op to {rz, sx, x, id}."""
    name, q = op.name, op.qubits[0]
    if name in ("rz", "sx", "id"):
        return [op]
    if name == "x" and basis_has_x:
        return [Op("x", (q,), ())]
    if name == "p":
        return u3_to_basis_ops(0.0, 0.0, op.params[0], q)
    if name == "rz":
        return [op]
    if name == "rx":
        return u3_to_basis_ops(op.params[0], -math.pi / 2, math.pi / 2, q)
    if name == "ry":
        return u3_to_basis_ops(op.params[0], 0.0, 0.0, q)
    if name == "u2":
        return u3_to_basis_ops(math.pi / 2, op.params[0], op.params[1], q)
    if name == "u3":
        return u3_to_basis_ops(*op.params, q)
    if name == "sxdg":
        # sxdg = rz(pi) sx rz(pi) (up to phase)
        return [Op("rz", (q,), (math.pi,)), Op("sx", (q,), ()),
                Op("rz", (q,), (math.pi,))]
    if name in _1Q_TO_U3:
        return u3_to_basis_ops(*_1Q_TO_U3[name], q)
    raise ValueError(f"cannot lower 1q op {name}")


# ---------------------------------------------------------------------------
# 2q decompositions into cx + 1q
# ---------------------------------------------------------------------------
def _lower_2q_to_cx(op: Op) -> List[Op]:
    a, b = op.qubits
    n = op.name
    if n == "cx":
        return [op]
    if n == "cz":
        return [Op("h", (b,)), Op("cx", (a, b)), Op("h", (b,))]
    if n == "cy":
        return [Op("sdg", (b,)), Op("cx", (a, b)), Op("s", (b,))]
    if n == "ch":
        # ch = (s⊗1)(1⊗h)(1⊗sdg) cx (1⊗h)(1⊗t) ... use standard decomposition
        return [Op("s", (b,)), Op("h", (b,)), Op("t", (b,)),
                Op("cx", (a, b)),
                Op("tdg", (b,)), Op("h", (b,)), Op("sdg", (b,))]
    if n == "swap":
        return [Op("cx", (a, b)), Op("cx", (b, a)), Op("cx", (a, b))]
    if n == "crz":
        t = op.params[0]
        return [Op("rz", (b,), (t / 2,)), Op("cx", (a, b)),
                Op("rz", (b,), (-t / 2,)), Op("cx", (a, b))]
    if n == "cp":
        t = op.params[0]
        return [Op("rz", (a,), (t / 2,)), Op("rz", (b,), (t / 2,)),
                Op("cx", (a, b)), Op("rz", (b,), (-t / 2,)),
                Op("cx", (a, b))]
    if n == "rzz":
        t = op.params[0]
        return [Op("cx", (a, b)), Op("rz", (b,), (t,)), Op("cx", (a, b))]
    if n == "rxx":
        t = op.params[0]
        return [Op("h", (a,)), Op("h", (b,)),
                Op("cx", (a, b)), Op("rz", (b,), (t,)), Op("cx", (a, b)),
                Op("h", (a,)), Op("h", (b,))]
    if n == "ryy":
        t = op.params[0]
        pre = [Op("sx", (a,)), Op("sx", (b,))]
        post = [Op("sxdg", (a,)), Op("sxdg", (b,))]
        return pre + [Op("cx", (a, b)), Op("rz", (b,), (t,)),
                      Op("cx", (a, b))] + post
    if n == "cu3":
        t, f, l = op.params
        # standard controlled-U decomposition (two CX)
        return (
            [Op("rz", (a,), ((l + f) / 2,)),
             Op("u3", (b,), (t / 2, f, 0.0))]
            + [Op("cx", (a, b)),
               Op("u3", (b,), (-t / 2, 0.0, -(f + l) / 2)),
               Op("cx", (a, b)),
               Op("rz", (b,), ((l - f) / 2,))]
        )
    if n == "ecr":
        return _ecr_via_cx(a, b)
    raise ValueError(f"cannot lower 2q op {n}")


def _ecr_via_cx(a: int, b: int) -> List[Op]:
    """ECR(a, b) as cx + 1q, derived from rzx(±pi/4) composition.

    rzx(t)(a,b) = exp(-i t/2 Z_a X_b) = h(b) · rzz(t)(a,b) · h(b).
    ECR = rzx(pi/4) · x(a) · rzx(-pi/4)  (qiskit definition).
    """
    def rzx(t):
        return [Op("h", (b,)), Op("cx", (a, b)), Op("rz", (b,), (t,)),
                Op("cx", (a, b)), Op("h", (b,))]

    return rzx(math.pi / 4) + [Op("x", (a,))] + rzx(-math.pi / 4)


def _cx_via_ecr(a: int, b: int) -> List[Op]:
    """CX(a, b) in the ECR basis (IBM Eagle devices).

    CX = (Y on a ⊗ I)·ECR·(S on a ⊗ SX† on b) up to global phase — local
    Clifford corrections found by exhaustive search over the 1q Clifford
    group and verified against the dense unitaries in tests.
    """
    return [Op("s", (a,)), Op("sxdg", (b,)),
            Op("ecr", (a, b)),
            Op("y", (a,))]


# ---------------------------------------------------------------------------
# routing: swap insertion for coupling maps
# ---------------------------------------------------------------------------
def _bfs_path(coupling: Sequence[Tuple[int, int]], n: int,
              src: int, dst: int) -> List[int]:
    adj: Dict[int, List[int]] = {i: [] for i in range(n)}
    for u, v in coupling:
        adj.setdefault(u, []).append(v)
        adj.setdefault(v, []).append(u)
    prev = {src: src}
    frontier = [src]
    while frontier and dst not in prev:
        nxt = []
        for u in frontier:
            for v in adj[u]:
                if v not in prev:
                    prev[v] = u
                    nxt.append(v)
        frontier = nxt
    if dst not in prev:
        raise ValueError(f"no path {src}->{dst} in coupling map")
    path = [dst]
    while path[-1] != src:
        path.append(prev[path[-1]])
    return path[::-1]


def transpile(circuit: Circuit,
              basis: Sequence[str] = ("cx", "id", "rz", "sx", "x"),
              coupling_map: Optional[Sequence[Tuple[int, int]]] = None,
              initial_layout: Optional[Sequence[int]] = None,
              num_qubits: Optional[int] = None) -> Circuit:
    """Lower to a hardware basis and (optionally) route onto a coupling map.

    Parity target: qiskit ``transpile(..., optimization_level=0)`` as used in
    the reference data pipelines — structural, not optimizing, deterministic.
    """
    basis = set(basis)
    two_q_native = "cx" if "cx" in basis else ("ecr" if "ecr" in basis else None)
    n_out = num_qubits or circuit.num_qubits
    out = Circuit(n_out, dict(circuit.metadata))

    layout = list(initial_layout) if initial_layout is not None \
        else list(range(circuit.num_qubits))
    if len(layout) < circuit.num_qubits:
        raise ValueError("initial_layout smaller than circuit width")

    def emit_1q(op: Op):
        if op.name in basis:
            out.ops.append(op)
        else:
            out.ops.extend(o for o in _lower_1q(op, "x" in basis))

    def emit_cx(a: int, b: int):
        if two_q_native == "cx":
            out.ops.append(Op("cx", (a, b)))
        elif two_q_native == "ecr":
            for o in _cx_via_ecr(a, b):
                if o.name in basis:
                    out.ops.append(o)
                else:
                    out.ops.extend(_lower_1q(o, "x" in basis))
        else:
            raise ValueError("basis has no 2q gate")

    def emit_2q(op: Op, a: int, b: int):
        if op.name in basis and op.name == two_q_native:
            out.ops.append(Op(op.name, (a, b), op.params))
            return
        for o in _lower_2q_to_cx(Op(op.name, (a, b), op.params)):
            if o.name == "cx":
                emit_cx(*o.qubits)
            else:
                emit_1q(o)

    for op in circuit.ops:
        if op.name in ("barrier",):
            out.ops.append(Op("barrier",
                              tuple(layout[q] for q in op.qubits
                                    if q < len(layout))))
            continue
        if op.name in ("measure", "delay", "reset"):
            out.ops.append(Op(op.name, tuple(layout[q] for q in op.qubits),
                              op.params))
            continue
        if len(op.qubits) == 1:
            emit_1q(Op(op.name, (layout[op.qubits[0]],), op.params))
            continue
        a, b = layout[op.qubits[0]], layout[op.qubits[1]]
        if coupling_map is not None:
            pairs = {(u, v) for u, v in coupling_map}
            if (a, b) not in pairs and (b, a) not in pairs:
                path = _bfs_path(coupling_map, n_out, a, b)
                # swap b's state along the path next to a
                for i in range(len(path) - 1, 1, -1):
                    u, v = path[i], path[i - 1]
                    for o in _lower_2q_to_cx(Op("swap", (u, v))):
                        emit_cx(*o.qubits)
                    # track logical→physical movement
                    for lq, pq in enumerate(layout):
                        if pq == u:
                            layout[lq] = v
                        elif pq == v:
                            layout[lq] = u
                b = path[1]
        emit_2q(op, a, b)
    # logical→physical positions after routing (final_layout[lq] = the
    # physical qubit holding logical lq's state) — callers that read
    # per-qubit observables off a routed circuit must select these columns
    out.metadata["final_layout"] = list(layout)
    return out
