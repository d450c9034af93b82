"""Noise models: per-gate channels + readout confusion.

Host-side equivalent of qiskit-aer's ``NoiseModel`` as used by the
reference: ``NoiseModel.from_backend`` (thermal relaxation + depolarizing
per gate, readout error on measure) → :meth:`NoiseModel.from_device`.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..ops.channels import (Channel, depol_param_for_target_error,
                            depolarizing_channel, readout_confusion,
                            thermal_relaxation_channel)
from .model import DeviceModel

_SWAP = np.array([[1, 0, 0, 0], [0, 0, 1, 0],
                  [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.complex128)


class NoiseModel:
    """Maps (gate, qubits) → :class:`Channel`, plus readout confusion."""

    def __init__(self, num_qubits: int):
        self.num_qubits = num_qubits
        self.local_channels: Dict[Tuple[str, Tuple[int, ...]], Channel] = {}
        self.default_channels: Dict[str, Channel] = {}
        # [nq, 2, 2] column-stochastic assignment matrices or None
        self.readout: Optional[np.ndarray] = None

    # -- construction -----------------------------------------------------
    def add_quantum_error(self, channel: Channel, gate: str,
                          qubits: Sequence[int]):
        self.local_channels[(gate, tuple(int(q) for q in qubits))] = channel
        return self

    def add_all_qubit_quantum_error(self, channel: Channel,
                                    gates: Sequence[str]):
        if isinstance(gates, str):
            gates = [gates]
        for g in gates:
            self.default_channels[g] = channel
        return self

    def set_readout_error(self, qubit: int, confusion: np.ndarray):
        if self.readout is None:
            self.readout = np.stack(
                [np.eye(2)] * self.num_qubits).astype(np.float64)
        self.readout[qubit] = confusion
        return self

    # -- queries ------------------------------------------------------------
    def channel_for(self, gate: str, qubits: Tuple[int, ...]
                    ) -> Optional[Channel]:
        ch = self.local_channels.get((gate, qubits))
        if ch is None and len(qubits) == 2:
            rev = self.local_channels.get((gate, qubits[::-1]))
            if rev is not None:
                # The stored channel's local tensor slots are laid out for
                # the opposite qubit order — conjugate each Kraus operator
                # by SWAP so direction-sensitive channels act on the right
                # qubits.
                ch = Channel([_SWAP @ k @ _SWAP for k in rev.kraus])
        if ch is None:
            ch = self.default_channels.get(gate)
        return ch

    # -- Aer-style construction from calibration ------------------------------
    @classmethod
    def from_device(cls, device: DeviceModel,
                    thermal_relaxation: bool = True,
                    depolarizing: bool = True,
                    readout_error: bool = True,
                    scale: float = 1.0) -> "NoiseModel":
        """``NoiseModel.from_backend`` parity.

        Per gate: depolarizing (strength solved so the composite hits the
        calibrated gate_error) composed with per-qubit thermal relaxation
        over the gate duration; symmetric readout confusion on measure.

        ``scale`` multiplies every calibrated error input (gate_error,
        gate duration, readout flip probability) — a "scale× noisier
        device" knob for matching a published noise regime.
        """
        nm = cls(device.num_qubits)
        for key, props in device.gates.items():
            parts = key.split("_")
            gate, qubits = parts[0], tuple(int(q) for q in parts[1:])
            nq = len(qubits)
            if gate == "rz" or props.gate_error == 0.0 and not thermal_relaxation:
                continue
            gate_error = min(props.gate_error * scale,
                             1.0 - 4.0 ** (-nq))  # max infidelity
            gate_length = props.gate_length * scale
            relax: Optional[Channel] = None
            if thermal_relaxation and gate_length > 0:
                locals_ = [thermal_relaxation_channel(
                    device.t1(q), device.t2(q), gate_length)
                    for q in qubits]
                if nq == 1:
                    relax = locals_[0]
                else:
                    relax = Channel([np.kron(k0, k1)
                                     for k0 in locals_[0].kraus
                                     for k1 in locals_[1].kraus])
            chan = relax
            if depolarizing and gate_error > 0:
                p = depol_param_for_target_error(gate_error, relax, nq)
                if p > 0:
                    dep = depolarizing_channel(min(p, 1.0), nq)
                    chan = dep if chan is None else dep.compose(chan)
            if chan is not None:
                nm.add_quantum_error(chan, gate, qubits)
        if readout_error:
            for q in range(device.num_qubits):
                p = min(device.readout_error(q) * scale, 0.5)
                if p > 0:
                    nm.set_readout_error(q, readout_confusion(p))
        return nm
