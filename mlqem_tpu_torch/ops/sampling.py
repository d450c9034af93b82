"""Shot sampling: probability vectors → outcomes, counts and sampled
expectation values, from a ``torch.Generator``.

Counterpart of ``mlqem_tpu/ops/sampling.py``. Every draw comes from the
generator passed in (on its own device), where the JAX package takes a key.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from .unitaries import popcount


def sample_outcomes(probs: torch.Tensor, shots: int,
                    generator: torch.Generator) -> torch.Tensor:
    """Basis-state outcomes: probs[..., D] → int32[..., shots].

    Inverse-CDF sampling: the normalized cumulative sum, then a binary
    search of each uniform in it (``searchsorted`` on the left side, as
    ``jnp.searchsorted``), clamped to D-1.
    """
    batch = probs.shape[:-1]
    D = probs.shape[-1]
    cdf = torch.cumsum(probs.to(dtype=torch.float32), dim=-1)
    cdf = cdf / cdf[..., -1:]
    u = torch.rand(tuple(batch) + (shots,), generator=generator,
                   dtype=torch.float32, device=generator.device)
    idx = torch.searchsorted(cdf.reshape(-1, D).contiguous(),
                             u.reshape(-1, shots))
    return idx.clamp_(max=D - 1).to(torch.int32).reshape(
        tuple(batch) + (shots,))


def sample_histogram(probs: torch.Tensor, shots: int, dim: int,
                     generator: torch.Generator) -> torch.Tensor:
    """Sampled histogram (counts vector): probs[..., D] → int32[..., dim]."""
    outcomes = sample_outcomes(probs, shots, generator).long()
    hist = torch.zeros(outcomes.shape[:-1] + (dim,), dtype=torch.int64,
                       device=outcomes.device)
    hist.scatter_add_(-1, outcomes, torch.ones_like(outcomes))
    return hist.to(torch.int32)


def sample_small_categorical(probs: torch.Tensor, shape: Sequence[int],
                             generator: torch.Generator) -> torch.Tensor:
    """int32 draws of ``shape`` from ``probs[..., K]``, K small.

    One uniform per draw and K-1 fused comparisons against the CDF
    (index = #{cdf_k < u}), so nothing of size ``shape × K`` is built.
    ``probs.shape[:-1]`` must broadcast against ``shape`` from the right.
    The draws come from ``generator`` on its own device.
    """
    p = probs.to(dtype=torch.float32)
    cdf = torch.cumsum(p, dim=-1)
    cdf = cdf / cdf[..., -1:]
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32,
                   device=generator.device)
    idx = torch.zeros(tuple(shape), dtype=torch.int32, device=u.device)
    for k in range(p.shape[-1] - 1):
        idx += u > cdf[..., k]
    return idx


def sampled_z_expectations(probs: torch.Tensor, shots: int, num_qubits: int,
                           generator: torch.Generator) -> torch.Tensor:
    """Per-qubit ⟨Z_q⟩ estimated from ``shots`` joint samples: [..., nq].

    Every qubit is read off the same outcomes, so the shot noise is
    correlated across qubits as on hardware.
    """
    outcomes = sample_outcomes(probs, shots, generator)
    return torch.stack([1.0 - 2.0 * ((outcomes >> q) & 1).float().mean(-1)
                        for q in range(num_qubits)], dim=-1)


def sampled_parity_expectation(probs: torch.Tensor, shots: int, z_mask: int,
                               generator: torch.Generator) -> torch.Tensor:
    """Sampled ⟨Π Z⟩ over the z_mask support."""
    outcomes = sample_outcomes(probs, shots, generator)
    par = popcount(outcomes & int(z_mask)) & 1
    return 1.0 - 2.0 * par.float().mean(-1)


def expectation_from_probs(probs: torch.Tensor, z_mask: int) -> torch.Tensor:
    """Exact ⟨Π Z⟩ over z_mask from a probability vector."""
    dim = probs.shape[-1]
    j = torch.arange(dim, dtype=torch.int64, device=probs.device)
    sign = 1 - 2 * (popcount(j & int(z_mask)) & 1)
    return torch.sum(probs * sign.to(probs.dtype), dim=-1)


def histogram_to_counts(hist: np.ndarray, num_qubits: int) -> Dict[str, int]:
    """Counts-dict view (qiskit bitstring format: leftmost = highest qubit)."""
    out = {}
    for j, c in enumerate(np.asarray(hist)):
        if c > 0:
            out[format(j, f"0{num_qubits}b")] = int(c)
    return out


def counts_to_probs(counts: Dict[str, int], num_qubits: int) -> np.ndarray:
    """Counts dict → probability vector (reference
    ``counts_to_feature_vector`` parity, ``data/utils.py:178-195``)."""
    dim = 2 ** num_qubits
    vec = np.zeros(dim, dtype=np.float64)
    shots = sum(counts.values())
    for bits, c in counts.items():
        vec[int(bits, 2)] = c / shots
    return vec
