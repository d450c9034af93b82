"""20Q digital ZNE + Pauli-twirling baseline (BASELINE config #4).

Counterpart of ``mlqem_tpu/workflows/zne_scale.py``. The noise-factor
sweep at 20 qubits: for each circuit, noisy ⟨Z_q⟩ at nf ∈ noise_factors
via the kicked-Ising Pauli-frame engine (noise_scale = analytic k-fold
channel composition = local 2q folding under twirled noise), then
per-qubit extrapolation to zero noise. Both noise factors and all
trajectories are batches on ``device``: K1 evolves them up to 13 qubits,
K3 at 14, K4 and the phases in torch from 15 (the default 20).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..device.model import DeviceModel
from ..metrics import rmse
from ..mitigation.zne import Extrapolator, LinearExtrapolator
from ..ops.kicked_ising import KickedIsingEngine


def zne_sweep_ising(device_model: DeviceModel,
                    nq: int = 20,
                    steps: int = 4,
                    J_values: Optional[np.ndarray] = None,
                    dt: float = 0.25,
                    h: float = 1.0,
                    noise_factors: Sequence[int] = (1, 3),
                    n_traj: int = 64,
                    shots: Optional[int] = 10000,
                    extrapolator: Optional[Extrapolator] = None,
                    seed: int = 0,
                    device: Union[str, torch.device] = "cuda") -> Dict:
    """ZNE over a J-sweep of nq-qubit Trotter circuits on ``device``.

    Returns ideal / noisy (nf=1) / extrapolated values + RMSE summary.
    """
    if J_values is None:
        J_values = np.linspace(0.05, 0.6, 16).astype(np.float32)
    J_values = np.asarray(J_values, np.float32)
    extrapolator = extrapolator or LinearExtrapolator()

    measured = {}
    ideal = None
    for k, nf in enumerate(noise_factors):
        eng = KickedIsingEngine(device_model, nq=nq, steps=steps,
                                device=device, dt=dt, h=h, n_traj=n_traj,
                                shots=shots, noise_scale=int(nf))
        i_vals, n_vals = eng.generate(J_values, seed=seed + k)
        del eng
        measured[nf] = n_vals
        if ideal is None:
            ideal = i_vals

    nfs = list(noise_factors)
    stacked = np.stack([measured[nf] for nf in nfs])   # [F, B, nq]
    F, B, NQ = stacked.shape
    zne_vals = np.zeros((B, NQ))
    for b in range(B):
        for q in range(NQ):
            zne_vals[b, q] = extrapolator.extrapolate(
                nfs, stacked[:, b, q])
    return {
        "J_values": J_values,
        "ideal": ideal,
        "noisy": measured[nfs[0]],
        "measured": measured,
        "zne": zne_vals,
        "rmse_noisy": float(rmse(measured[nfs[0]], ideal)),
        "rmse_zne": float(rmse(zne_vals, ideal)),
    }
