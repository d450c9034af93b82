"""Device model: calibration snapshot schema + accessors.

Replaces the reference's qiskit ``BackendV1`` fake-backend fleet as the
source of calibration features and noise parameters. The ``properties()``
dict mirrors ``get_backend_properties_v1``
(``blackwater/data/utils.py:139-175``) so feature encoders produce the same
schema the reference models were trained on.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class QubitProps:
    t1: float
    t2: float
    readout_error: float
    frequency: float = 5.0e9


@dataclasses.dataclass
class GateProps:
    gate_error: float
    gate_length: float


class DeviceModel:
    """A quantum device's static description: topology + calibration.

    Args:
        name: device name.
        num_qubits: qubit count.
        basis_gates: native gate names.
        coupling_map: directed list of (control, target) pairs.
        qubits: per-qubit calibration.
        gates: dict 'gate_q0[_q1]' → GateProps.
        readout_length: measurement duration in seconds.
    """

    def __init__(self, name: str, num_qubits: int,
                 basis_gates: Sequence[str],
                 coupling_map: Sequence[Tuple[int, int]],
                 qubits: Sequence[QubitProps],
                 gates: Dict[str, GateProps],
                 readout_length: float = 5.0e-6):
        self.name = name
        self.num_qubits = int(num_qubits)
        self.basis_gates = list(basis_gates)
        self.coupling_map = [tuple(p) for p in coupling_map]
        self.qubits = list(qubits)
        self.gates = dict(gates)
        self.readout_length = readout_length

    # -- calibration accessors ------------------------------------------------
    @staticmethod
    def gate_key(gate: str, qubits: Sequence[int]) -> str:
        return f"{gate}_{'_'.join(str(q) for q in qubits)}"

    def gate_props(self, gate: str, qubits: Sequence[int]) -> GateProps:
        key = self.gate_key(gate, qubits)
        if key in self.gates:
            return self.gates[key]
        if len(qubits) == 2:  # try reversed direction
            rkey = self.gate_key(gate, list(qubits)[::-1])
            if rkey in self.gates:
                return self.gates[rkey]
        return GateProps(0.0, 0.0)

    def gate_error(self, gate: str, qubits) -> float:
        if isinstance(qubits, (int, np.integer)):
            qubits = (int(qubits),)
        return self.gate_props(gate, qubits).gate_error

    def gate_length(self, gate: str, qubits) -> float:
        if isinstance(qubits, (int, np.integer)):
            qubits = (int(qubits),)
        return self.gate_props(gate, qubits).gate_length

    def t1(self, q: int) -> float:
        return self.qubits[q].t1

    def t2(self, q: int) -> float:
        return self.qubits[q].t2

    def readout_error(self, q: int) -> float:
        return self.qubits[q].readout_error

    @property
    def gates_set(self) -> List[str]:
        return sorted({k.split("_")[0] for k in self.gates})

    # -- reference-schema snapshot -------------------------------------------
    def properties(self) -> dict:
        """Calibration snapshot in the reference's schema.

        Matches ``get_backend_properties_v1`` output
        (``blackwater/data/utils.py:156-175``) field-for-field so
        ``encode_data``-style feature extraction is drop-in compatible.
        """
        return {
            "name": self.name,
            "gates_set": self.gates_set,
            "num_qubits": self.num_qubits,
            "qubits_props": {
                i: {
                    "index": i,
                    "t1": self.qubits[i].t1,
                    "t2": self.qubits[i].t2,
                    "readout_error": self.qubits[i].readout_error,
                }
                for i in range(self.num_qubits)
            },
            "gate_props": {
                key: {
                    "index": key,
                    "gate_error": gp.gate_error,
                    "gate_length": gp.gate_length,
                }
                for key, gp in self.gates.items()
            },
        }

    # -- serialization ---------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "num_qubits": self.num_qubits,
            "basis_gates": self.basis_gates,
            "coupling_map": [list(p) for p in self.coupling_map],
            "qubits": [dataclasses.asdict(q) for q in self.qubits],
            "gates": {k: dataclasses.asdict(g) for k, g in self.gates.items()},
            "readout_length": self.readout_length,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "DeviceModel":
        qubits = [QubitProps(**{k: v for k, v in q.items()
                                if k in ("t1", "t2", "readout_error",
                                         "frequency")})
                  for q in d["qubits"]]
        gates = {k: GateProps(g["gate_error"], g["gate_length"])
                 for k, g in d["gates"].items()}
        return cls(d["name"], d["num_qubits"], d["basis_gates"],
                   [tuple(p) for p in d["coupling_map"]], qubits, gates,
                   d.get("readout_length", 5.0e-6))

    @classmethod
    def from_json(cls, path: str) -> "DeviceModel":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def save_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)

    def __repr__(self):
        return f"<DeviceModel {self.name} nq={self.num_qubits}>"
