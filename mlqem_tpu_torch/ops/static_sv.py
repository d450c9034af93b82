"""The template statevector names of the JAX package, in torch.

Counterpart of ``mlqem_tpu/ops/static_sv.py``. There, a template (shared
topology, batched parameters) runs on its own reshape/einsum engine, and
the batch-last functions (``run_static_tlast``, ``run_trajectories_tlast``)
lay the batch along the TPU's 128 lanes. The port's statevector engines
already batch templates natively, with one index set for every row, so
these names call them and return what their JAX counterparts return:
ideal states from :func:`statevector.apply_circuit`, trajectory
ensembles from :func:`trajectory.run_trajectories_presampled`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..circuits.circuit import CircuitTensor
from .statevector import apply_circuit, zero_state


def static_pairs(ct: CircuitTensor) -> List[Tuple[int, int]]:
    """Host-side (a, b) per op slot (b = embedding partner for 1q ops)."""
    q = np.asarray(ct.qubits).reshape(-1, 2)
    return [(int(a), int(b)) for a, b in q]


def run_static(ct_struct: CircuitTensor, params: torch.Tensor,
               state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ideal statevector(s) for a template: params[..., L, 3] batched.

    ``ct_struct`` supplies the shared gate_ids/qubits (unbatched); leading
    dims of ``params`` become batch dims of the state, on params' device.
    """
    params = torch.as_tensor(params, dtype=torch.float32)
    if state is None:
        state = zero_state(ct_struct.num_qubits, device=params.device)
    return apply_circuit(state, dataclasses.replace(ct_struct,
                                                    params=params))


def run_trajectories_static(ct_struct: CircuitTensor, params: torch.Tensor,
                            choices: torch.Tensor, n_traj: int
                            ) -> torch.Tensor:
    """Pauli-twirled trajectories of a template: params [B, L, 3], choices
    int[B, n_traj, L] sampled Pauli indices per op → states [B, T, 2^n]."""
    from .trajectory import run_trajectories_presampled

    if choices.shape[1] != n_traj:
        raise ValueError(f"choices carry {choices.shape[1]} trajectories, "
                         f"not n_traj={n_traj}")
    return run_trajectories_presampled(ct_struct, params, choices,
                                       ct_struct.num_qubits)


# the JAX package's batch-last layout is the TPU's; the results are these
run_trajectories_tlast = run_trajectories_static


def run_static_tlast(ct_struct: CircuitTensor, params: torch.Tensor
                     ) -> torch.Tensor:
    """Ideal batched statevectors → [B, 2^n], as the JAX batch-last
    function returns them."""
    return run_static(ct_struct, params)
