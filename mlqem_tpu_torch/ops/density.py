"""Measurement-side ops on probability vectors."""
from __future__ import annotations

import torch


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
