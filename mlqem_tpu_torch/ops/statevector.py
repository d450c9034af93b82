"""Batched statevector simulator, in torch.

Counterpart of ``mlqem_tpu/ops/statevector.py``, the ideal arm of every
label pipeline. Every op is a uniform 4x4 unitary applied through bit-index
gathers. The JAX package ``vmap``s one circuit at a time; here a batch runs
natively: where the batch shares its qubits (a template), one index set
serves every row, and where each circuit has its own (a
:func:`stack_circuits` batch), each row gathers with its own indices.

The 4x4 product is written out as elementwise complex products and a sum,
so it stays IEEE f32 whatever the matmul precision settings are.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from ..circuits.circuit import Circuit, CircuitTensor, stack_circuits
from ..circuits.observables import PauliSum
from .unitaries import COMPLEX_DTYPE, op_unitaries, pair_indices, popcount


# From this width on, apply_op builds a shared op's gather indices on the
# state's device: on the host they cost a host pass and a host-to-device
# copy of 2^n int64 an op (455 s of a 28-qubit, 224-op circuit on an H100
# against 4.7 s); below it, one small copy beats a dozen tiny launches.
_DEVICE_INDEX_N = 16


def _sim_width(num_qubits: int) -> int:
    return max(num_qubits, 2)


def zero_state(num_qubits: int, batch_shape=(), device="cuda",
               dtype=COMPLEX_DTYPE) -> torch.Tensor:
    n = _sim_width(num_qubits)
    state = torch.zeros(tuple(batch_shape) + (2 ** n,), dtype=dtype,
                        device=device)
    state[..., 0] = 1.0
    return state


def _matvec4(mat4: torch.Tensor, amps: torch.Tensor) -> torch.Tensor:
    """Σ_j mat4[..., i, j]·amps[..., j, r] as elementwise products."""
    return (mat4[..., :, :, None] * amps[..., None, :, :]).sum(dim=-2)


def apply_op(state: torch.Tensor, mat4: torch.Tensor, a, b, n: int
             ) -> torch.Tensor:
    """Apply 4x4 unitaries at qubits (a, b) to a state, in place.

    ``a``/``b`` are ints, one qubit pair for every state: state
    [..., 2**n], mat4 [4, 4] or one per state [..., 4, 4]. Or they are int
    tensors [B], a pair per row: state [B, 2**n], mat4 [B, 4, 4].
    """
    if isinstance(a, int) and isinstance(b, int):
        if n < _DEVICE_INDEX_N:
            idx = pair_indices(a, b, n).to(state.device)    # [4, R]
        else:   # built where the state lives (2 GiB at 28 qubits)
            a, b = (torch.tensor(q, device=state.device) for q in (a, b))
            idx = pair_indices(a, b, n)
        state[..., idx] = _matvec4(mat4, state[..., idx])
        return state
    idx = pair_indices(a, b, n).to(state.device)            # [B, 4, R]
    flat = idx.reshape(idx.shape[0], -1)
    amps = torch.gather(state, 1, flat).reshape(idx.shape)
    return state.scatter_(1, flat, _matvec4(mat4, amps).reshape(flat.shape))


def apply_circuit(state: torch.Tensor, ct: CircuitTensor) -> torch.Tensor:
    """Run all ops of a tensorized circuit (batch) over state[..., 2**n].

    The batch is the broadcast of state's, ``gate_ids``', ``qubits``' and
    ``params``' leading dims; qubits without leading dims are shared.
    """
    n = _sim_width(ct.num_qubits)
    dim = 2 ** n
    params = torch.as_tensor(ct.params, dtype=torch.float32,
                             device=state.device)
    qubits = np.asarray(ct.qubits)
    mats = op_unitaries(ct.gate_ids, params)               # [..., L, 4, 4]
    L = mats.shape[-3]
    batch = torch.broadcast_shapes(state.shape[:-1], mats.shape[:-3],
                                   qubits.shape[:-2])
    rows = int(np.prod(batch))
    out = state.expand(batch + (dim,)).reshape(rows, dim).clone()
    mats = mats.expand(batch + (L, 4, 4)).reshape(rows, L, 4, 4)
    if qubits.ndim == 2:
        for l in range(L):
            out = apply_op(out, mats[:, l], int(qubits[l, 0]),
                           int(qubits[l, 1]), n)
    else:
        q = torch.as_tensor(np.broadcast_to(
            qubits, batch + qubits.shape[-2:]).reshape(rows, L, 2).copy(),
            device=state.device)
        for l in range(L):
            out = apply_op(out, mats[:, l], q[:, l, 0], q[:, l, 1], n)
    return out.reshape(batch + (dim,))


def statevector(ct: CircuitTensor, device="cuda") -> torch.Tensor:
    """|ψ⟩ = U_circuit |0…0⟩: complex64 [..., 2**n] for the ct's batch.

    Runs on ``params``' device when it is a tensor, else on ``device`` (the
    card unless the caller asks for the CPU).
    """
    if torch.is_tensor(ct.params):
        device = ct.params.device
    return apply_circuit(zero_state(ct.num_qubits, device=device), ct)


# ---------------------------------------------------------------------------
# Expectation values
# ---------------------------------------------------------------------------
def expval_pauli_masks(state: torch.Tensor, x_mask: int, z_mask: int,
                       y_count: int, n: int) -> torch.Tensor:
    """⟨ψ|P|ψ⟩ for a single Pauli given bitmasks.

    P = ⊗_q σ_q with x_mask/z_mask per :meth:`PauliTerm.masks`;
    ⟨ψ|P|ψ⟩ = Σ_j conj(ψ_j)·(-i)^{#Y}·(-1)^{popcount(j & z_mask)}·ψ_{j⊕x}.
    """
    dim = state.shape[-1]
    j = torch.arange(dim, dtype=torch.int64, device=state.device)
    sign = (1 - 2 * (popcount(j & int(z_mask)) & 1)).to(torch.float32)
    phase = (-1j) ** (y_count % 4)
    flipped = state[..., j ^ int(x_mask)]
    vals = torch.sum(torch.conj(state) * sign * flipped, dim=-1) * phase
    return vals.real


def expval_pauli_sum(state: torch.Tensor, obs: PauliSum) -> torch.Tensor:
    """⟨ψ|O|ψ⟩ for a PauliSum observable (Python loop over terms)."""
    n = int(np.log2(state.shape[-1]))
    total = 0.0
    xs, zs = obs.masks()
    for term, x, z in zip(obs.terms, xs, zs):
        y_count = sum(1 for c in term.pauli if c == "Y")
        total = total + float(np.real(term.coeff)) * expval_pauli_masks(
            state, int(x), int(z), y_count, n)
    return total


def probabilities(state: torch.Tensor) -> torch.Tensor:
    return state.real * state.real + state.imag * state.imag


def _signs(dim: int, device) -> torch.Tensor:
    """(−1)^{bit_q(j)} as f32 [nq_max, dim] for every bit of j < dim."""
    j = torch.arange(dim, dtype=torch.int64, device=device)
    bits = dim.bit_length() - 1
    q = torch.arange(bits, dtype=torch.int64, device=device)
    return (1 - 2 * ((j[None, :] >> q[:, None]) & 1)).to(torch.float32)


def z_expectations(probs: torch.Tensor, num_qubits: int) -> torch.Tensor:
    """Per-qubit ⟨Z_q⟩ from a probability vector: [..., dim] → [..., nq].

    Physics convention (+1 for bit value 0), as in the JAX package.
    """
    sign = _signs(probs.shape[-1], probs.device)
    return torch.stack([(probs * sign[q]).sum(dim=-1)
                        for q in range(num_qubits)], dim=-1)


def all_z_expectation(probs: torch.Tensor, num_qubits: int) -> torch.Tensor:
    """⟨Z⊗…⊗Z⟩ from probabilities (``cal_all_z_exp`` parity)."""
    dim = probs.shape[-1]
    j = torch.arange(dim, dtype=torch.int64, device=probs.device)
    sign = 1 - 2 * (popcount(j & (2 ** num_qubits - 1)) & 1)
    return torch.sum(probs * sign.to(probs.dtype), dim=-1)


# ---------------------------------------------------------------------------
# High-level batched entry points
# ---------------------------------------------------------------------------
def batch_statevectors(ct: CircuitTensor, device="cuda") -> torch.Tensor:
    """Statevectors for a batch: gate_ids[B, L] → complex64 [B, 2**n]."""
    return statevector(ct, device)


def ideal_expectation_values(circuits: Union[Sequence[Circuit],
                                             CircuitTensor],
                             observables: Union[Sequence[PauliSum],
                                                PauliSum],
                             device="cuda") -> np.ndarray:
    """Exact ⟨O⟩ per circuit, as numpy: one observable for all circuits
    or one per circuit."""
    ct = circuits if isinstance(circuits, CircuitTensor) \
        else stack_circuits(list(circuits))
    states = batch_statevectors(ct, device)
    if isinstance(observables, PauliSum):
        return expval_pauli_sum(states, observables).cpu().numpy()
    return np.array([expval_pauli_sum(states[i], obs).cpu().numpy()
                     for i, obs in enumerate(observables)])
