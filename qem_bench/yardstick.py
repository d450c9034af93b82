"""The frozen arithmetic that the benchmark measures against.

Published NVIDIA H100 SXM peaks (dense, at the 700 W power limit) and the
least work of a kicked-Ising Trotter step. Later changes to the program
are measured against these numbers and functions unchanged.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12             # H100 SXM, published
F32_FLOPS_PER_S = 67e12               # H100 SXM, f32 outside the tensor cores


def bound(n_bytes: float, n_flops: float) -> float:
    """The least seconds the card could take: the larger of the bytes over
    the memory bandwidth and the f32 operations over the f32 peak."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / F32_FLOPS_PER_S)


def step_flops(nq: int, nb: int, dim: int) -> int:
    """The least f32 operations of one kicked-Ising Trotter step on one row,
    whatever implements it: two unscaled WHTs (1 add per amplitude per stage
    and plane: 4·nq·dim; the 2^(−nq/2) folds into the phases' cos and sin),
    two complex rotations (6 per amplitude: 12·dim), and the phases' angles:
    with ±1 signs the sign sum takes nq + 1 values (nb + 1 for ZZ) per row
    and step, each a scale and a sincos counted as 2 (3·(nq + nb + 2))."""
    return 4 * nq * dim + 12 * dim + 3 * (nq + nb + 2)


def kicked_evolve_work(rows: int, nq: int, nb: int, steps: int):
    """(bytes, flops) of the kicked engine's evolution stage: |0…0⟩ through
    ``steps`` steps to the probabilities [rows, 2^nq]. It reads the ±1 signs
    [rows, steps·(nq + nb)] and the couplings [rows] and writes the f32
    probabilities; |0…0⟩ is not read. Operations: ``step_flops`` a step and
    row, and |ψ|² (3 an amplitude)."""
    dim = 2 ** nq
    n_bytes = 4 * rows * (steps * (nq + nb) + 1) + 4 * rows * dim
    n_flops = rows * (steps * step_flops(nq, nb, dim) + 3 * dim)
    return n_bytes, n_flops


def window_evolve_work(rows: int, w: int, nb: int, steps: int):
    """(bytes, flops) of a light-cone window's evolution with its per-step
    ⟨Z_obs⟩: the f32 re/im state makes one round trip through device memory
    a step, the signs and couplings are read once, and a step costs
    ``step_flops`` plus the ⟨Z_obs⟩ reduction (|ψ|², the sign and the sum:
    5 an amplitude)."""
    dim = 2 ** w
    n_bytes = (steps * 2 * 8 * rows * dim
               + 4 * rows * (steps * (w + nb) + 1))
    n_flops = rows * steps * (step_flops(w, nb, dim) + 5 * dim)
    return n_bytes, n_flops
