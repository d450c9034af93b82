"""Batched density-matrix simulator with noise channels, in torch.

Counterpart of ``mlqem_tpu/ops/density.py``: the exact-noise engine for
batches whose circuits differ (the Estimator primitives). Every op, unitary
and its attached noise channel, is one 16×16 superoperator applied to the
local block of the density matrix at the op's qubit pair. The JAX package
``vmap``s one circuit at a time; here a batch runs natively, each row with
its own qubit pair, through ``torch.gather``/``scatter_``.

Superoperator convention (as the JAX package): the local block
G[p, q] = ρ[row_p, col_q] with p, q = 2·v_a + v_b (qubit a the MSB), flat
index k = 4p + q; S maps k_in → k_out. Every product of this path is a
matmul guarded by :func:`check_ieee_matmul` (the exact engine stays IEEE
f32, as the JAX one pins ``Precision.HIGHEST``) or an elementwise product.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..circuits.circuit import CircuitTensor
from ..circuits.observables import PauliSum
from .kernels.wht import check_ieee_matmul
from .unitaries import COMPLEX_DTYPE, op_unitaries, pair_indices, popcount


def _sim_width(num_qubits: int) -> int:
    return max(num_qubits, 2)


def density_zero(num_qubits: int, batch_shape=(), device="cuda",
                 dtype=COMPLEX_DTYPE) -> torch.Tensor:
    n = _sim_width(num_qubits)
    dm = torch.zeros(tuple(batch_shape) + (2 ** n, 2 ** n), dtype=dtype,
                     device=device)
    dm[..., 0, 0] = 1.0
    return dm


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (broadcast batched), refused under TF32."""
    check_ieee_matmul(b)
    return torch.matmul(a, b)


def gate_superop(mat: torch.Tensor) -> torch.Tensor:
    """Unitary superoperator kron(U, conj(U)): [..., d, d] → [..., d², d²]
    (an outer product, written elementwise)."""
    d = mat.shape[-1]
    out = mat[..., :, None, :, None] * torch.conj(mat)[..., None, :, None, :]
    return out.reshape(mat.shape[:-2] + (d * d, d * d))


def apply_superop(dm: torch.Tensor, s16: torch.Tensor, a, b, n: int
                  ) -> torch.Tensor:
    """Apply 16×16 local superoperators at qubits (a, b) to dm [B, 2^n, 2^n].

    ``a``/``b`` are ints (one pair for every row) or int tensors [B] (a
    pair per row); s16 is [16, 16] or one per row [B, 16, 16]. The rows
    and columns of pair_indices' 4 × 2^(n-2) index set cover every index
    once, so the block is the whole matrix with its axes permuted: one
    gather per axis brings the block forward, one scatter per axis puts
    the result back.
    """
    B, dim = dm.shape[0], dm.shape[-1]
    R = dim // 4
    a = torch.as_tensor(a, dtype=torch.int64).expand(B)
    b = torch.as_tensor(b, dtype=torch.int64).expand(B)
    perm = pair_indices(a, b, n).to(dm.device).reshape(B, dim)   # [B, 4R]
    rows = perm[:, :, None].expand(B, dim, dim)
    cols = perm[:, None, :].expand(B, dim, dim)
    block = torch.gather(torch.gather(dm, 1, rows), 2, cols)
    # [B, p, r, q, s] → [B, (p q), (r s)]: the superop contracts (p, q)
    v16 = block.reshape(B, 4, R, 4, R).permute(0, 1, 3, 2, 4).reshape(
        B, 16, R * R)
    new = matmul(s16, v16).reshape(B, 4, 4, R, R).permute(
        0, 1, 3, 2, 4).reshape(B, dim, dim)
    out = torch.empty_like(dm).scatter_(1, rows, new)
    return torch.empty_like(dm).scatter_(2, cols, out)


def run_density(ct: CircuitTensor, key_ids, noise_table,
                dm0: Optional[torch.Tensor] = None,
                device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """Evolve |0..0⟩⟨0..0| (or dm0) through circuit(s) + noise.

    ``ct``'s leading dims are the batch (qubits without them are shared);
    key_ids int[..., L] index noise_table complex[K, 16, 16] (numpy or a
    tensor; entry 0 = identity), the channel applied after each op. Runs
    on dm0's device when given, else on ``device``. Returns complex64
    [..., 2^n, 2^n].
    """
    n = _sim_width(ct.num_qubits)
    dim = 2 ** n
    if dm0 is not None:
        device = dm0.device
    gate_ids = np.asarray(ct.gate_ids)
    L = gate_ids.shape[-1]
    params = torch.as_tensor(ct.params, dtype=torch.float32, device=device)
    qubits = np.asarray(ct.qubits)
    keys = np.asarray(key_ids, np.int64)
    batch = tuple(np.broadcast_shapes(gate_ids.shape[:-1], qubits.shape[:-2],
                                      keys.shape[:-1], tuple(params.shape[:-2]),
                                      () if dm0 is None
                                      else tuple(dm0.shape[:-2])))
    rows = int(np.prod(batch))
    mats = op_unitaries(gate_ids, params).expand(
        batch + (L, 4, 4)).reshape(rows, L, 4, 4)
    if not torch.is_tensor(noise_table):
        noise_table = np.asarray(noise_table, np.complex64)
    table = torch.as_tensor(noise_table, device=device).to(COMPLEX_DTYPE)
    keys = torch.as_tensor(np.broadcast_to(keys, batch + (L,)).reshape(
        rows, L).copy(), device=device)
    q = torch.as_tensor(np.broadcast_to(qubits, batch + (L, 2)).reshape(
        rows, L, 2).copy(), device=device)
    if dm0 is None:
        dm = density_zero(n, (rows,), device)
    else:
        dm = dm0.to(COMPLEX_DTYPE).expand(batch + (dim, dim)).reshape(
            rows, dim, dim)
    for l in range(L):
        s16 = matmul(table[keys[:, l]], gate_superop(mats[:, l]))
        dm = apply_superop(dm, s16, q[:, l, 0], q[:, l, 1], n)
    return dm.reshape(batch + (dim, dim))


def batch_density_matrices(ct: CircuitTensor, key_ids, noise_table,
                           device: Union[str, torch.device] = "cuda"
                           ) -> torch.Tensor:
    """Density matrices for a circuit batch: complex64 [B, 2^n, 2^n]."""
    return run_density(ct, key_ids, noise_table, device=device)


def batch_density_matrices_from(ct: CircuitTensor, key_ids, noise_table,
                                dm0: torch.Tensor) -> torch.Tensor:
    """Evolve a batch of initial density matrices dm0 [B, 2^n, 2^n] through
    a circuit batch (per-group measurement-basis rotations, with their
    noise, applied to already-evolved states), on dm0's device."""
    return run_density(ct, key_ids, noise_table, dm0=dm0)


# ---------------------------------------------------------------------------
# Measurement-side ops
# ---------------------------------------------------------------------------
def dm_probabilities(dm: torch.Tensor) -> torch.Tensor:
    """Diagonal of ρ, the Z-basis outcome distribution: a new f32 tensor
    [..., 2^n], so the caller may free dm."""
    return torch.diagonal(dm, dim1=-2, dim2=-1).real.clone()


def apply_readout_confusion(probs: torch.Tensor, confusion: torch.Tensor,
                            num_qubits: int) -> torch.Tensor:
    """Apply per-qubit 2×2 assignment matrices to a probability vector.

    probs [..., 2^n]; confusion [nq, 2, 2] column-stochastic M[meas, true].
    Per qubit q the amplitude axis is viewed as [..., high, 2, low] and the
    bit axis contracted with M[q], written out as two products and a sum
    so that it stays IEEE f32 whatever the matmul precision settings.
    """
    dim = probs.shape[-1]
    batch = probs.shape[:-1]
    m = confusion.to(dtype=probs.dtype)
    for q in range(num_qubits):
        low, high = 2 ** q, dim // (2 ** (q + 1))
        p = probs.reshape(batch + (high, 2, low))
        t0, t1 = p[..., 0, :], p[..., 1, :]
        probs = torch.stack((m[q, 0, 0] * t0 + m[q, 0, 1] * t1,
                             m[q, 1, 0] * t0 + m[q, 1, 1] * t1),
                            dim=-2).reshape(batch + (dim,))
    return probs


def readout_affine(confusion: Optional[np.ndarray]) -> Tuple[float, float]:
    """⟨Z⟩ marginal of a column-stochastic confusion C (C[i,j] =
    P(meas=i | true=j)): z_meas = a·z_true + b."""
    if confusion is None:
        return 1.0, 0.0
    C = np.asarray(confusion, np.float64)
    a = (C[0, 0] - C[1, 0] + C[1, 1] - C[0, 1]) / 2.0
    b = (C[0, 0] - C[1, 0] - C[1, 1] + C[0, 1]) / 2.0
    return float(a), float(b)


def expval_pauli_dm(dm: torch.Tensor, x_mask: int, z_mask: int,
                    y_count: int) -> torch.Tensor:
    """tr(Pρ) = Σ_j amp(j)·ρ[j⊕x, j], amp(j) = (−i)^#Y·(−1)^popcount(j&z)."""
    dim = dm.shape[-1]
    j = torch.arange(dim, dtype=torch.int64, device=dm.device)
    sign = (1 - 2 * (popcount(j & int(z_mask)) & 1)).to(torch.float32)
    phase = (-1j) ** (y_count % 4)
    vals = torch.sum(dm[..., j ^ int(x_mask), j] * sign, dim=-1) * phase
    return vals.real


def expval_pauli_sum_dm(dm: torch.Tensor, obs: PauliSum) -> torch.Tensor:
    total = 0.0
    xs, zs = obs.masks()
    for term, x, z in zip(obs.terms, xs, zs):
        y_count = sum(1 for c in term.pauli if c == "Y")
        total = total + float(np.real(term.coeff)) * expval_pauli_dm(
            dm, int(x), int(z), y_count)
    return total


def purity(dm: torch.Tensor) -> torch.Tensor:
    """tr(ρ²), as an elementwise product and sum."""
    return (dm * dm.transpose(-2, -1)).sum(dim=(-2, -1)).real
