"""A frozen copy of the port's ``configurable_device`` draw.

The calibration numbers (T1, T2, readout error per qubit; error and length
of each directed CX; the single-qubit gate error) of a line device of
``num_qubits`` qubits, drawn from ``numpy.random.default_rng(seed)`` in the
order the port draws them. Both the program (through its ``DeviceModel``)
and the plain reference take these numbers.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

T1_MEAN, CX_ERR_MEAN = 1.2e-4, 7e-3
SX_ERR_MEAN, READOUT_ERR_MEAN = 2.5e-4, 1.5e-2


def line_device(num_qubits: int, seed: int) -> Dict:
    rng = np.random.default_rng(seed)
    t1, t2, ro = [], [], []
    for _ in range(num_qubits):
        a = float(T1_MEAN * rng.lognormal(0.0, 0.35))
        t1.append(a)
        t2.append(float(min(a * rng.uniform(0.6, 1.8), 2 * a)))
        ro.append(float(READOUT_ERR_MEAN * rng.lognormal(0, 0.4)))
    pairs = sorted({(q, q + 1) for q in range(num_qubits - 1)}
                   | {(q + 1, q) for q in range(num_qubits - 1)})
    cx = {}
    for a, b in pairs:
        err = float(CX_ERR_MEAN * rng.lognormal(0, 0.4))
        cx[(a, b)] = (err, float(rng.uniform(3.0e-7, 5.5e-7)))
    sx = [float(SX_ERR_MEAN * rng.lognormal(0, 0.4))
          for _ in range(num_qubits)]
    return {"num_qubits": num_qubits, "t1": t1, "t2": t2,
            "readout_error": ro, "cx": cx, "sx_error": sx}


def device_model(cal: Dict):
    """The port's ``DeviceModel`` of these numbers (the gates and names of
    its ``configurable_device``)."""
    from mlqem_tpu_torch.device.model import DeviceModel, GateProps, QubitProps

    n = cal["num_qubits"]
    qubits = [QubitProps(t1=a, t2=b, readout_error=r)
              for a, b, r in zip(cal["t1"], cal["t2"], cal["readout_error"])]
    gates = {f"cx_{a}_{b}": GateProps(e, t)
             for (a, b), (e, t) in cal["cx"].items()}
    for q in range(n):
        for g in ("sx", "x", "id"):
            gates[f"{g}_{q}"] = GateProps(cal["sx_error"][q], 3.55e-8)
        gates[f"rz_{q}"] = GateProps(0.0, 0.0)
        gates[f"reset_{q}"] = GateProps(0.0, 5.8e-6)
    coupling = []
    for q in range(n - 1):
        coupling += [(q, q + 1), (q + 1, q)]
    return DeviceModel(f"configurable_{n}q", n, ["cx", "id", "rz", "sx", "x"],
                       coupling, qubits, gates)
