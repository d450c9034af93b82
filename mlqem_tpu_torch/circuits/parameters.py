"""Symbolic circuit parameters + batched binding.

Counterpart of ``mlqem_tpu/circuits/parameters.py``. A parameterized
circuit tensorizes once into a *template* whose parameter slots are filled
from a value batch with one torch index-put, on the values' device, so a
whole parameter sweep runs through the simulators as one batch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from .circuit import Circuit, CircuitTensor, tensorize
from .gates import is_structural


class Parameter:
    """A named symbolic parameter (linear expressions: coeff * p)."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return f"Parameter({self.name})"

    def __mul__(self, other):
        return ParameterExpression(self, float(other))

    __rmul__ = __mul__

    def __neg__(self):
        return ParameterExpression(self, -1.0)


@dataclasses.dataclass(frozen=True)
class ParameterExpression:
    """coeff * parameter (the only symbolic form the circuit families need)."""

    parameter: Parameter
    coeff: float = 1.0

    def __mul__(self, other):
        return ParameterExpression(self.parameter, self.coeff * float(other))

    __rmul__ = __mul__

    def __neg__(self):
        return ParameterExpression(self.parameter, -self.coeff)


def _is_symbolic(p) -> bool:
    return isinstance(p, (Parameter, ParameterExpression))


def circuit_parameters(circuit: Circuit) -> List[Parameter]:
    """Distinct parameters in first-appearance order."""
    seen: Dict[str, Parameter] = {}
    for op in circuit.ops:
        for p in op.params:
            if isinstance(p, Parameter) and p.name not in seen:
                seen[p.name] = p
            elif isinstance(p, ParameterExpression) \
                    and p.parameter.name not in seen:
                seen[p.parameter.name] = p.parameter
    return list(seen.values())


def bind_parameters(circuit: Circuit, values) -> Circuit:
    """Concrete circuit with parameters substituted.

    ``values``: sequence (ordered like :func:`circuit_parameters`) or
    dict name→value.
    """
    params = circuit_parameters(circuit)
    if not isinstance(values, dict):
        values = {p.name: float(v) for p, v in zip(params, values)}
    out = Circuit(circuit.num_qubits, dict(circuit.metadata))
    from .circuit import Op

    for op in circuit.ops:
        new_params = []
        for p in op.params:
            if isinstance(p, Parameter):
                new_params.append(values[p.name])
            elif isinstance(p, ParameterExpression):
                new_params.append(p.coeff * values[p.parameter.name])
            else:
                new_params.append(p)
        out.ops.append(Op(op.name, op.qubits, tuple(new_params)))
    return out


@dataclasses.dataclass
class CircuitTemplate:
    """Tensorized parameterized circuit, bound by an index-put.

    ``params_base`` holds concrete values (0 at symbolic slots);
    binding computes ``params_base + coeffs·values[param_idx]`` scattered at
    (op_slot, param_slot).
    """

    ct: CircuitTensor
    slot_op: np.ndarray      # int32[S] op index of each symbolic slot
    slot_par: np.ndarray     # int32[S] which of the 3 param slots
    slot_param: np.ndarray   # int32[S] parameter index
    slot_coeff: np.ndarray   # float32[S]
    parameters: List[Parameter]

    @property
    def num_parameters(self) -> int:
        return len(self.parameters)

    def bind_host(self, values: np.ndarray) -> CircuitTensor:
        """Host-side (numpy) binding — for init-time inspection paths where
        eager device dispatch would be wasteful (e.g. noise-table builds)."""
        values = np.asarray(values, np.float32)
        base = np.array(self.ct.params, np.float32)
        if self.slot_op.size:
            base[self.slot_op, self.slot_par] = (
                values[self.slot_param] * self.slot_coeff)
        return CircuitTensor(np.asarray(self.ct.gate_ids),
                             np.asarray(self.ct.qubits), base,
                             self.ct.num_qubits)

    def bind(self, values) -> CircuitTensor:
        """values: float[..., P] → CircuitTensor with batched params.

        ``params`` becomes a float32 torch tensor [..., L, 3] on the values'
        device: a broadcast copy of the base params with the symbolic slots
        put in. gate_ids/qubits stay unbatched host arrays (shared topology).
        """
        values = torch.as_tensor(values, dtype=torch.float32)
        batch = values.shape[:-1]
        base = torch.as_tensor(np.asarray(self.ct.params, np.float32),
                               device=values.device)
        base = base.expand(batch + base.shape).clone()
        if self.slot_op.size:
            def idx(a):
                return torch.as_tensor(a, dtype=torch.long,
                                       device=values.device)

            coeff = torch.as_tensor(self.slot_coeff, device=values.device)
            base[..., idx(self.slot_op), idx(self.slot_par)] = (
                values[..., idx(self.slot_param)] * coeff)
        return CircuitTensor(self.ct.gate_ids, self.ct.qubits, base,
                             self.ct.num_qubits)


def tensorize_template(circuit: Circuit, max_ops=None) -> CircuitTemplate:
    """Tensorize a parameterized circuit into a bindable template."""
    params = circuit_parameters(circuit)
    index = {p.name: i for i, p in enumerate(params)}
    # temporarily zero out symbolic params to reuse `tensorize`
    concrete = bind_parameters(circuit, {p.name: 0.0 for p in params})
    ct = tensorize(concrete, max_ops)
    slot_op, slot_par, slot_param, slot_coeff = [], [], [], []
    op_idx = 0
    for op in circuit.ops:
        if is_structural(op.name):
            continue
        for j, p in enumerate(op.params[:3]):
            if isinstance(p, Parameter):
                slot_op.append(op_idx)
                slot_par.append(j)
                slot_param.append(index[p.name])
                slot_coeff.append(1.0)
            elif isinstance(p, ParameterExpression):
                slot_op.append(op_idx)
                slot_par.append(j)
                slot_param.append(index[p.parameter.name])
                slot_coeff.append(p.coeff)
        op_idx += 1
    return CircuitTemplate(
        ct,
        np.asarray(slot_op, np.int32),
        np.asarray(slot_par, np.int32),
        np.asarray(slot_param, np.int32),
        np.asarray(slot_coeff, np.float32),
        params,
    )
