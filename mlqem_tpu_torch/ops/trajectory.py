"""Pauli-twirled noise tables (host numpy) and the gather trajectory engine.

A noise channel is projected onto its Pauli-twirled form: a Pauli channel
whose probabilities are the Walsh–Hadamard transform of the channel's
Pauli-transfer-matrix diagonal. The kicked-Ising engine samples one of the
16 two-qubit Paulis after every CX from these tables; the generic engines
sample one after every op (:func:`twirled_noise_tables`).

:func:`run_trajectories_presampled` is the generic trajectory engine for a
template: each trajectory is a statevector run in which every op's 4x4 is
multiplied by its sampled Pauli (any gate set; plain torch).
:func:`_batch_trajectories` does the same for a batch of circuits that
differ, each with its own per-op noise table, and draws the Paulis itself
from one ``torch.Generator`` (the JAX package takes a key per circuit).
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..circuits.circuit import CircuitTensor
from ..device.noise import NoiseModel, op_channels
from ..utils.profiling import span
from .channels import Channel
from .density import apply_readout_confusion
from . import sampling
from .statevector import _matvec4, apply_op, probabilities, z_expectations
from .unitaries import COMPLEX_DTYPE, op_unitaries

# the 16 two-qubit Paulis in (a=MSB, b=LSB) order: index = 4*pa + pb
_P1 = [np.eye(2), np.array([[0, 1], [1, 0]]),
       np.array([[0, -1j], [1j, 0]]), np.diag([1, -1])]
PAULI_4X4 = np.stack([np.kron(_P1[a], _P1[b])
                      for a in range(4) for b in range(4)]).astype(
    np.complex64)


def _walsh() -> np.ndarray:
    w = np.zeros((16, 16), np.float32)

    def masks(i):
        a, b = divmod(i, 4)
        return (a in (1, 2), a in (2, 3), b in (1, 2), b in (2, 3))

    for qi in range(16):
        xq = masks(qi)
        for pi in range(16):
            xp = masks(pi)
            # symplectic product per qubit
            s = (xq[0] & xp[1]) ^ (xq[1] & xp[0]) \
                ^ (xq[2] & xp[3]) ^ (xq[3] & xp[2])
            w[qi, pi] = -1.0 if s else 1.0
    w.flags.writeable = False
    return w


_WALSH = _walsh()


def walsh_sign_matrix() -> np.ndarray:
    """w[P, Q] = ±1 commutation signs over the 16 2q Paulis (read-only).

    Pauli-channel composition is multiplication in this basis:
    f = w @ p are the channel's Pauli fidelities, and applying the channel
    k times gives probabilities p_k = (w @ f^k) / 16 (w·w = 16·I).
    """
    return _WALSH


def compose_pauli_channel(probs: np.ndarray, k: int) -> np.ndarray:
    """k-fold self-composition of a 2q Pauli channel (Walsh domain)."""
    w = walsh_sign_matrix()
    f = w @ probs
    p = (w @ (f ** k)) / 16.0
    p = np.clip(p, 0.0, None)
    s = p.sum()
    return p / s if s > 0 else p


def pauli_channel_probs(channel: Channel) -> np.ndarray:
    """Pauli-twirled probabilities p[16] of a 2q channel.

    p_Q = (1/16) Σ_P w(Q,P) · R_P with R_P = tr(P E(P))/4 the PTM diagonal
    and w(Q,P) = ±1 for commuting/anticommuting Pauli pairs. The span
    ``trajectory.twirl``.
    """
    with span("trajectory.twirl"):
        ch = channel.expand_to_2q(0) if channel.dim == 2 else channel
        R = np.zeros(16)
        for i, P in enumerate(PAULI_4X4):
            acc = np.zeros((4, 4), dtype=np.complex128)
            for K in ch.kraus:
                acc += K @ P @ np.conj(K.T)
            R[i] = np.real(np.trace(P @ acc)) / 4.0
        p = (walsh_sign_matrix().astype(np.float64) @ R) / 16.0
        p = np.clip(p, 0.0, None)
        s = p.sum()
        if s > 0:
            p = p / s
        return p


def twirled_noise_tables(ct: CircuitTensor, noise: Optional[NoiseModel]
                         ) -> np.ndarray:
    """Per-op Pauli-channel probabilities: float32[..., L, 16].

    Built from the same (gate, qubits) channel lookup as the dm engine
    (``device.noise.op_channels``); noiseless ops and NOP padding
    get p = [1, 0, …] (identity).
    """
    key_ids, channels = op_channels(ct, noise)
    table = np.stack([np.eye(1, 16, 0, dtype=np.float32)[0]] + [
        pauli_channel_probs(c).astype(np.float32) for c in channels])
    return table[key_ids]


# the JAX package's name for applying per-state 4x4s at shared qubits
apply_op_batched_mat = apply_op


def run_trajectories_presampled(ct_struct: CircuitTensor,
                                params: torch.Tensor,
                                choices: torch.Tensor,
                                num_qubits: int) -> torch.Tensor:
    """Trajectory ensemble with pre-sampled Pauli choices (gather engine).

    params [B, L, 3], choices int [B, T, L] → states complex64
    [B, T, 2^n] on params' device. The shared gate_ids/qubits [L] come
    from ``ct_struct`` (a template). After op l, trajectory t carries the
    2q Pauli ``choices[b, t, l]`` (index 4·p_a + p_b) on the op's qubits.
    """
    n = max(num_qubits, 2)
    params = torch.as_tensor(params, dtype=torch.float32)
    device = params.device
    qubits = np.asarray(ct_struct.qubits)
    mats = op_unitaries(ct_struct.gate_ids, params)         # [B, L, 4, 4]
    paulis = torch.as_tensor(PAULI_4X4, device=device)
    choices = torch.as_tensor(choices, device=device).long()
    B, T, L = choices.shape
    state = torch.zeros((B, T, 2 ** n), dtype=COMPLEX_DTYPE, device=device)
    state[..., 0] = 1.0
    for l in range(L):
        noise = paulis[choices[:, :, l]]                    # [B, T, 4, 4]
        full = (noise[..., :, :, None]
                * mats[:, None, l, None, :, :]).sum(dim=-2)
        state = apply_op_batched_mat(state, full, int(qubits[l, 0]),
                                     int(qubits[l, 1]), n)
    return state


def _batch_trajectories(gate_ids, qubits, params, pauli_probs,
                        generator: torch.Generator, n_traj: int,
                        num_qubits: int) -> torch.Tensor:
    """Trajectory statevectors for a circuit batch: complex64
    [B, n_traj, 2^n] on the generator's device.

    gate_ids [B, L], qubits [B, L, 2], params [B, L, 3] (one circuit per
    row) and pauli_probs [B, L, 16] (per-op twirled noise). The Pauli
    after every (circuit, trajectory, op) is drawn from ``generator``; each
    row then gathers with its own qubit pair.
    """
    n = max(num_qubits, 2)
    device = generator.device
    params = torch.as_tensor(params, dtype=torch.float32, device=device)
    mats = op_unitaries(gate_ids, params)                   # [B, L, 4, 4]
    B, L = mats.shape[:2]
    probs = torch.as_tensor(np.asarray(pauli_probs, np.float32),
                            device=device)
    choices = sampling.sample_small_categorical(
        probs[:, None], (B, n_traj, L), generator).long()
    paulis = torch.as_tensor(PAULI_4X4, device=device)
    q = torch.as_tensor(np.repeat(np.asarray(qubits, np.int64).reshape(
        B, 1, L, 2), n_traj, axis=1).reshape(B * n_traj, L, 2),
        device=device)
    state = torch.zeros((B * n_traj, 2 ** n), dtype=COMPLEX_DTYPE,
                        device=device)
    state[:, 0] = 1.0
    for l in range(L):
        full = _matvec4(paulis[choices[:, :, l]], mats[:, None, l])
        state = apply_op(state, full.reshape(B * n_traj, 4, 4),
                         q[:, l, 0], q[:, l, 1], n)
    return state.reshape(B, n_traj, 2 ** n)


def run_trajectories(ct: CircuitTensor, pauli_probs, n_traj: int,
                     generator: torch.Generator) -> torch.Tensor:
    """Trajectory statevectors for ONE circuit: complex64 [n_traj, 2^n].

    pauli_probs: float32[L, 16] per-op twirled noise.
    """
    return _batch_trajectories(
        np.asarray(ct.gate_ids)[None], np.asarray(ct.qubits)[None],
        torch.as_tensor(ct.params)[None], np.asarray(pauli_probs)[None],
        generator, n_traj, ct.num_qubits)[0]


def trajectory_z_labels(ct: CircuitTensor, noise: Optional[NoiseModel],
                        n_traj: int, shots_per_traj: Optional[int],
                        seed: int = 0,
                        readout: Optional[np.ndarray] = None,
                        device: Union[str, torch.device] = "cuda"
                        ) -> np.ndarray:
    """Noisy per-qubit ⟨Z⟩ labels [B, nq] for a circuit batch via
    trajectories, as numpy.

    Total effective shots = n_traj × shots_per_traj (or the exact
    trajectory average when shots_per_traj is None). Readout error is
    applied to each trajectory's outcome distribution before sampling.
    The draws come from one generator on ``device`` seeded with ``seed``.
    """
    nq = ct.num_qubits
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    states = _batch_trajectories(ct.gate_ids, ct.qubits, ct.params,
                                 twirled_noise_tables(ct, noise), generator,
                                 n_traj, nq)                 # [B, T, dim]
    probs = probabilities(states)
    del states
    if readout is not None:
        probs = apply_readout_confusion(
            probs, torch.as_tensor(np.asarray(readout, np.float32),
                                   device=probs.device), nq)
    if shots_per_traj is None:
        return z_expectations(probs, nq).mean(dim=1).cpu().numpy()
    return sampling.sampled_z_expectations(
        probs, shots_per_traj, nq, generator).mean(dim=1).cpu().numpy()
