"""Demo reproductions: the part of ``mlqem_tpu/workflows/demos.py`` the port
runs so far.

:func:`lightcone_crosscheck` holds the light-cone engine against
precomputed Pauli-propagation values, such as the K=131072 audit values
that ship in ``docs/demos/results/audit_values_tpu.npz``. Recomputing
those values needs ``PauliPropagatorIsing`` (ROADMAP item 17), and the
demo1 pipeline itself (``demo1_zne_mimic_100q``) is ported with the rest
of the workflows (ROADMAP item 18); both wait.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ..device.model import DeviceModel
from ..device.registry import configurable_device
from ..ops.lightcone import LightconeIsing

# Channel-strength scale at which demo1's synthetic 100q device reproduces
# the ibm_brisbane campaign's noise (the JAX package's calibration).
DEMO1_CALIBRATED_SCALE = 2.5


def lightcone_crosscheck(device_model: Optional[DeviceModel] = None,
                         nq: int = 100,
                         steps: int = 6,
                         dt: float = 0.5,
                         h: float = 0.5 * np.pi,
                         J_values: Sequence[float] = (0.05, 0.3, 0.55),
                         qubits: Sequence[int] = (0, 24, 49, 74, 99),
                         max_terms: int = 16384,
                         noise_factors: Sequence[float] = (1, 3),
                         n_traj: int = 4096,
                         ideal_tol: float = 1e-3,
                         noisy_tol: float = 0.03,
                         reference: Optional[Mapping[str, np.ndarray]] = None,
                         seed: int = 1,
                         device: Union[str, torch.device] = "cuda") -> Dict:
    """Cross-validate the exact light-cone engine against Pauli-propagation
    values at depths where the truncated engine has converged.

    The ideal arm is exact against exact (tolerance ``ideal_tol``); the
    noisy arms compare ``n_traj`` sampled trajectories against the exact
    twirled-channel damping, so their tolerance is statistical.
    ``reference`` supplies the values ({"ideal"/"nf1"/"nf3": [B, ≥steps,
    Q]}) for this (J_values, qubits, dt, h, device_model) configuration;
    ``max_terms`` names the truncation they were computed at.
    ``device`` is the torch device the engines run on.
    """
    if reference is None:
        raise NotImplementedError(
            "recomputing the Pauli-propagation reference needs "
            "PauliPropagatorIsing, which the port does not have yet (ROADMAP "
            "item 17): pass reference= precomputed values")
    device_model = device_model or configurable_device(nq, seed=seed)
    J_arr = np.asarray(list(J_values), np.float32)
    qubits = [q for q in qubits if q < nq]

    def pp_values(arm):
        return np.asarray(reference[arm])[:, :steps, :]

    lc_exact = LightconeIsing(device_model, nq=nq, steps=steps,
                              device=device, dt=dt, h=h, n_traj=1,
                              shots=None, noise=False, readout=False)
    lc_ideal = lc_exact.ideal_stepwise(J_arr, qubits=qubits)
    out: Dict = {
        "config": {"nq": nq, "steps": steps, "dt": dt, "h": float(h),
                   "J_values": list(map(float, J_values)),
                   "qubits": list(qubits), "max_terms": max_terms,
                   "n_traj": n_traj, "reference": "precomputed"},
        "ideal_max_diff": float(np.abs(lc_ideal - pp_values("ideal")).max()),
        "ideal_tol": ideal_tol,
        "noisy_max_diff": {},
        "noisy_tol": noisy_tol,
    }
    lc_noisy = LightconeIsing(device_model, nq=nq, steps=steps,
                              device=device, dt=dt, h=h, n_traj=n_traj,
                              shots=None)
    for nf in noise_factors:
        lc_v, _ = lc_noisy.generate_stepwise(J_arr, noise_scale=nf,
                                             qubits=qubits, seed=seed,
                                             want_ideal=False)
        out["noisy_max_diff"][f"nf{int(nf)}"] = float(
            np.abs(lc_v - pp_values(f"nf{int(nf)}")).max())
    out["passed"] = bool(
        out["ideal_max_diff"] <= ideal_tol
        and all(v <= noisy_tol for v in out["noisy_max_diff"].values()))
    return out
