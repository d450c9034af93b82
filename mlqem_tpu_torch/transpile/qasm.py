"""OpenQASM 2.0 import/export (interchange with qiskit users).

Counterpart of ``mlqem_tpu/transpile/qasm.py``, host only. Covers the
qelib1 subset matching the gate vocabulary — enough to round-trip the
reference's embedded QASM circuits (e.g. the transpiled ansatz in
``blackwater mlp.py:256``) and to move circuits between this framework and
qiskit without a qiskit dependency. Parameter expressions are numbers and
``pi`` under + - * / ** and parentheses, evaluated on their syntax tree.
"""
from __future__ import annotations

import ast
import math
import operator
import re
from typing import List, Optional

from ..circuits.circuit import Circuit

_QASM_NAMES = {
    "id": "id", "x": "x", "y": "y", "z": "z", "h": "h", "s": "s",
    "sdg": "sdg", "t": "t", "tdg": "tdg", "sx": "sx", "sxdg": "sxdg",
    "rx": "rx", "ry": "ry", "rz": "rz", "p": "u1", "u2": "u2", "u3": "u3",
    "cx": "cx", "cy": "cy", "cz": "cz", "ch": "ch", "swap": "swap",
    "crz": "crz", "cp": "cu1", "rzz": "rzz", "rxx": "rxx", "ecr": "ecr",
    "cu3": "cu3", "measure": "measure", "barrier": "barrier",
}
_FROM_QASM = {v: k for k, v in _QASM_NAMES.items()}
_FROM_QASM["u1"] = "p"
_FROM_QASM["cu1"] = "cp"
_FROM_QASM["u"] = "u3"


def to_qasm(circuit: Circuit) -> str:
    """Serialize to OpenQASM 2.0."""
    n = circuit.num_qubits
    lines = ['OPENQASM 2.0;', 'include "qelib1.inc";',
             f"qreg q[{n}];"]
    n_meas = sum(1 for op in circuit.ops if op.name == "measure")
    if n_meas:
        lines.append(f"creg meas[{n_meas}];")
    meas_idx = 0
    for op in circuit.ops:
        if op.name in ("delay", "reset", "nop"):
            continue
        qasm_name = _QASM_NAMES.get(op.name)
        if qasm_name is None:
            raise ValueError(f"gate {op.name!r} has no QASM 2.0 form")
        qubits = ",".join(f"q[{q}]" for q in op.qubits)
        if op.name == "measure":
            lines.append(f"measure q[{op.qubits[0]}] -> meas[{meas_idx}];")
            meas_idx += 1
        elif op.name == "barrier":
            lines.append(f"barrier {qubits};")
        elif op.params:
            params = ",".join(repr(float(p)) for p in op.params)
            lines.append(f"{qasm_name}({params}) {qubits};")
        else:
            lines.append(f"{qasm_name} {qubits};")
    return "\n".join(lines) + "\n"


_TOKEN = re.compile(
    r"^\s*(\w+)\s*(?:\(([^)]*)\))?\s+(.*?);\s*$")
_QUBIT = re.compile(r"q\[(\d+)\]")
_BINARY = {ast.Add: operator.add, ast.Sub: operator.sub,
           ast.Mult: operator.mul, ast.Div: operator.truediv,
           ast.Pow: operator.pow}
_UNARY = {ast.UAdd: operator.pos, ast.USub: operator.neg}


def _eval_node(node: ast.AST) -> float:
    if isinstance(node, ast.Constant) and isinstance(node.value,
                                                     (int, float)):
        return node.value
    if isinstance(node, ast.Name) and node.id == "pi":
        return math.pi
    if isinstance(node, ast.BinOp) and type(node.op) in _BINARY:
        return _BINARY[type(node.op)](_eval_node(node.left),
                                      _eval_node(node.right))
    if isinstance(node, ast.UnaryOp) and type(node.op) in _UNARY:
        return _UNARY[type(node.op)](_eval_node(node.operand))
    raise ValueError(f"unsupported parameter expression node "
                     f"{ast.dump(node)}")


def _eval_param(expr: str) -> float:
    """Evaluate a QASM parameter expression (pi arithmetic only)."""
    expr = expr.strip()
    if not re.fullmatch(r"[0-9eE\.\+\-\*/\(\)piPI\s]*", expr):
        raise ValueError(f"unsupported parameter expression {expr!r}")
    try:
        tree = ast.parse(expr, mode="eval")
    except SyntaxError as exc:
        raise ValueError(f"unsupported parameter expression {expr!r}"
                         ) from exc
    return float(_eval_node(tree.body))


def from_qasm(text: str) -> Circuit:
    """Parse an OpenQASM 2.0 program (qelib1 subset)."""
    body: List[str] = []
    for raw in text.split("\n"):
        line = raw.split("//")[0].strip()
        if not line:
            continue
        for stmt in line.split(";"):
            stmt = stmt.strip()
            if stmt:
                body.append(stmt + ";")
    qc: Optional[Circuit] = None
    for stmt in body:
        if stmt.startswith(("OPENQASM", "include", "creg")):
            continue
        m = re.match(r"qreg\s+(\w+)\[(\d+)\];", stmt)
        if m:
            qc = Circuit(int(m.group(2)))
            continue
        if qc is None:
            raise ValueError("qreg declaration missing before gates")
        m = re.match(r"measure\s+q\[(\d+)\]\s*->\s*\w+\[\d+\];", stmt)
        if m:
            qc.measure(int(m.group(1)))
            continue
        m = _TOKEN.match(stmt)
        if not m:
            raise ValueError(f"cannot parse QASM statement {stmt!r}")
        name, params_s, args = m.groups()
        qubits = [int(x) for x in _QUBIT.findall(args)]
        if name == "barrier":
            qc.barrier(qubits if qubits else None)
            continue
        our = _FROM_QASM.get(name)
        if our is None:
            raise ValueError(f"unsupported QASM gate {name!r}")
        params = tuple(_eval_param(p) for p in params_s.split(",")) \
            if params_s else ()
        qc.append(our, tuple(qubits), params)
    if qc is None:
        raise ValueError("no qreg found")
    return qc
