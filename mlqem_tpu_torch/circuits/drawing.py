"""ASCII circuit drawing (qiskit ``circuit.draw('text')`` usability parity)."""
from __future__ import annotations

from typing import List

from .circuit import Circuit
from .gates import GATE_NUM_QUBITS, is_structural


def draw(circuit: Circuit, max_width: int = 120) -> str:
    """Render a circuit as per-qubit wire lines.

    Example::

        q0: ─H──●────────M─
        q1: ────X──RZ(0.50)──M─
    """
    n = circuit.num_qubits
    lines: List[List[str]] = [[] for _ in range(n)]

    def pad_to_sync(qubits):
        width = max(len("".join(lines[q])) for q in qubits)
        for q in qubits:
            cur = len("".join(lines[q]))
            if cur < width:
                lines[q].append("─" * (width - cur))

    for op in circuit.ops:
        if op.name == "barrier":
            pad_to_sync(range(n))
            for q in range(n):
                lines[q].append("░")
            continue
        if op.name == "measure":
            lines[op.qubits[0]].append("─M─")
            continue
        if is_structural(op.name):
            continue
        label = op.name.upper()
        if op.params:
            vals = ",".join(f"{float(p):.2f}" for p in op.params
                            if isinstance(p, (int, float)))
            if vals:
                label = f"{label}({vals})"
        if GATE_NUM_QUBITS.get(op.name, 1) == 2:
            a, b = op.qubits
            pad_to_sync((a, b))
            if op.name == "cx":
                lines[a].append("─●─")
                lines[b].append("─X─")
            elif op.name == "cz":
                lines[a].append("─●─")
                lines[b].append("─●─")
            else:
                lines[a].append(f"─{label}:0─")
                lines[b].append(f"─{label}:1─")
        else:
            lines[op.qubits[0]].append(f"─{label}─")

    pad_to_sync(range(n))
    out = []
    for q in range(n):
        row = "".join(lines[q])
        if len(row) > max_width:
            row = row[: max_width - 1] + "…"
        out.append(f"q{q}: {row}")
    return "\n".join(out)
