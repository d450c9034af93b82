"""Noise models: per-gate channels + readout confusion.

Host-side equivalent of qiskit-aer's ``NoiseModel`` as used by the
reference: ``NoiseModel.from_backend`` (thermal relaxation + depolarizing
per gate, readout error on measure) → :meth:`NoiseModel.from_device`;
``RemoveReadoutErrors`` → :meth:`NoiseModel.without_readout`;
``AddNoise.add_coherent_noise`` (coherent RX(π+θ) CX over-rotation ⊗
depolarizing ⊗ thermal relaxation) → :func:`add_coherent_cx_noise`.
A noise model compiles into a per-op 16×16 superoperator table
(:func:`compile_noise_table`) and per-qubit readout matrices
(:func:`readout_matrices`).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..circuits.circuit import CircuitTensor
from ..circuits.gates import GATE_NAMES, GATE_NUM_QUBITS
from ..ops.channels import (Channel, coherent_overrotation_cx,
                            depol_param_for_target_error,
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

    def has_noise(self) -> bool:
        return bool(self.local_channels or self.default_channels
                    or self.readout is not None)

    # -- reference-parity transforms ----------------------------------------
    def without_readout(self) -> "NoiseModel":
        """``RemoveReadoutErrors`` parity: strip measurement errors."""
        out = self.copy()
        out.readout = None
        return out

    def without_gate(self, gate: str) -> "NoiseModel":
        """Delete all channels attached to one gate (e.g. 'cx')."""
        out = self.copy()
        out.local_channels = {k: v for k, v in out.local_channels.items()
                              if k[0] != gate}
        out.default_channels = {k: v for k, v in out.default_channels.items()
                                if k != gate}
        return out

    def copy(self) -> "NoiseModel":
        out = NoiseModel(self.num_qubits)
        out.local_channels = dict(self.local_channels)
        out.default_channels = dict(self.default_channels)
        out.readout = None if self.readout is None else self.readout.copy()
        return out

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


def add_coherent_cx_noise(device: DeviceModel,
                          theta: float,
                          uniform: bool = False,
                          add_depolarization: bool = True,
                          add_coherent: bool = True,
                          seed: Optional[int] = None,
                          base: Optional[NoiseModel] = None,
                          scale: float = 1.0) -> NoiseModel:
    """``AddNoise.add_coherent_noise`` parity (``noise_utils.py:69-144``).

    Strips the device's CX errors and replaces them per coupling direction
    with coherent RX(π+θ) over-rotation (uniform θ, or per-edge θ ~ U[0, θ]
    from ``np.random.default_rng(seed)``) optionally composed with
    depolarizing + thermal relaxation.

    ``scale`` multiplies the incoherent parts (depolarizing strength,
    relaxation duration) and the base model's channels; scale the coherent
    angle by passing a scaled ``theta``.
    """
    nm = (base or NoiseModel.from_device(device, scale=scale)
          ).without_gate("cx")
    rng = np.random.default_rng(seed)
    pairs = [p for p in device.coupling_map]
    thetas = ([theta] * len(pairs) if uniform
              else rng.uniform(0, theta, size=len(pairs)).tolist())
    for (a, b), th in zip(pairs, thetas):
        chan = None
        if add_coherent:
            chan = coherent_overrotation_cx(th)
        if add_depolarization:
            props = device.gate_props("cx", (a, b))
            relax0 = thermal_relaxation_channel(
                device.t1(a), device.t2(a), props.gate_length * scale)
            relax1 = thermal_relaxation_channel(
                device.t1(b), device.t2(b), props.gate_length * scale)
            dep = depolarizing_channel(
                min(props.gate_error * scale, 1.0 - 4.0 ** -2), 2)
            extra = dep.compose(relax0.expand_to_2q(0)).compose(
                relax1.expand_to_2q(1))
            chan = extra if chan is None else chan.compose(extra)
        if chan is not None:
            nm.add_quantum_error(chan, "cx", (a, b))
    return nm


# ---------------------------------------------------------------------------
# Compilation to the table form
# ---------------------------------------------------------------------------
def op_channels(ct: CircuitTensor, noise: Optional[NoiseModel]
                ) -> Tuple[np.ndarray, List[Channel]]:
    """The noise channel after every op, one per distinct (gate, qubits).

    Returns (key_ids, channels): key_ids int32 has ``ct.gate_ids``'s shape;
    op k is followed by ``channels[key_ids[k] - 1]``, or by no channel at
    key 0 (NOP padding and noiseless ops). Keys count in order of first
    appearance.
    """
    gate_ids = np.asarray(ct.gate_ids)
    flat_q = np.asarray(ct.qubits).reshape(-1, 2)
    flat_k = np.zeros(gate_ids.size, dtype=np.int32)
    channels: List[Channel] = []
    if noise is None or not (noise.local_channels or noise.default_channels):
        return flat_k.reshape(gate_ids.shape), channels
    lookup: Dict[Tuple[int, int, int], int] = {}
    for idx, g in enumerate(gate_ids.reshape(-1).tolist()):
        if g == 0:
            continue
        a, b = int(flat_q[idx, 0]), int(flat_q[idx, 1])
        if (g, a, b) not in lookup:
            name = GATE_NAMES[g]
            two = GATE_NUM_QUBITS.get(name, 1) == 2
            chan = noise.channel_for(name, (a, b) if two else (a,))
            if chan is not None:
                channels.append(chan)
            lookup[(g, a, b)] = 0 if chan is None else len(channels)
        flat_k[idx] = lookup[(g, a, b)]
    return flat_k.reshape(gate_ids.shape), channels


def compile_noise_table(ct: CircuitTensor, noise: Optional[NoiseModel]
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Build (key_ids, table) for the density-matrix engine.

    key_ids has ``ct.gate_ids``'s shape; ``table[k]`` is the 16×16 noise
    superoperator applied *after* op k's unitary (identity at key 0).
    For 1q gates the channel acts on local slot 0 (the gate qubit = MSB).
    """
    key_ids, channels = op_channels(ct, noise)
    table = [np.eye(16, dtype=np.complex128)] + [
        (c.expand_to_2q(0) if c.dim == 2 else c).superop() for c in channels]
    return key_ids, np.stack(table)


def readout_matrices(noise: Optional[NoiseModel], num_qubits: int
                     ) -> Optional[np.ndarray]:
    """[nq, 2, 2] confusion matrices, or None if no readout error."""
    if noise is None or noise.readout is None:
        return None
    return noise.readout[:num_qubits]
