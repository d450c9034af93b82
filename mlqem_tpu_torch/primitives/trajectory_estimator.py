"""Trajectory-based noisy Estimator: arbitrary circuits beyond dm widths.

Counterpart of ``mlqem_tpu/primitives/trajectory_estimator.py``. The exact
density-matrix backend (:class:`NoisyEstimator`) holds 4^n state; this one
estimates noisy expectation values with Pauli-twirled trajectories on
statevectors (2^n), for arbitrary circuit batches, and composes with
``zne()`` like any other backend.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..circuits.circuit import stack_circuits
from ..device.model import DeviceModel
from ..device.noise import NoiseModel
from ..ops.density import apply_readout_confusion
from ..ops.sampling import expectation_from_probs, sampled_parity_expectation
from ..ops.statevector import probabilities
from ..ops.trajectory import _batch_trajectories, twirled_noise_tables
from .estimator import (BaseEstimator, EstimatorResult, Job,
                        _basis_rotation_circuit, _noise_model,
                        _normalize_run_args, _seeded)


class TrajectoryEstimator(BaseEstimator):
    """Noisy expectation values via Pauli-twirled trajectory sampling.

    Args:
        backend: DeviceModel (noise auto-built) or NoiseModel.
        n_traj: trajectories per circuit (noise realizations).
        shots: None → exact trajectory mean; int → adds sampled shot noise.
        readout: include assignment error.
        seed: seed of the generator every draw comes from.
        device: the torch device the simulation runs on.
    """

    def __init__(self, backend: Union[DeviceModel, NoiseModel, None] = None,
                 n_traj: int = 64, shots: Optional[int] = None,
                 readout: bool = True, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        self.noise_model = _noise_model(backend)
        self.n_traj = n_traj
        self.shots = shots
        self.readout = readout
        self.device = torch.device(device)
        self._generator = _seeded(self.device, seed)

    def _run(self, circuits, observables, parameter_values=None,
             **run_options) -> Job:
        shots = run_options.get("shots", self.shots)
        circuits, observables = _normalize_run_args(
            circuits, observables, parameter_values)
        n = circuits[0].num_qubits
        # basis-rotate each circuit per its terms: one job per (circuit, term)
        jobs = []      # (circuit_with_rotation, z_support, coeff, out_idx)
        for i, (qc, obs) in enumerate(zip(circuits, observables)):
            for term in obs.terms:
                x_mask, z_mask = term.masks()
                rot = _basis_rotation_circuit(term, n)
                jobs.append((qc.compose(rot), int(x_mask | z_mask),
                             float(np.real(term.coeff)), i))
        ct = stack_circuits([j[0] for j in jobs])
        states = _batch_trajectories(
            ct.gate_ids, ct.qubits, ct.params,
            twirled_noise_tables(ct, self.noise_model), self._generator,
            self.n_traj, n)                              # [B, T, dim]
        probs = probabilities(states)
        del states
        if self.readout and self.noise_model is not None \
                and self.noise_model.readout is not None:
            probs = apply_readout_confusion(
                probs, torch.as_tensor(np.asarray(
                    self.noise_model.readout[:n], np.float32),
                    device=self.device), n)

        values = np.zeros(len(circuits), dtype=np.float64)
        for (_, support, coeff, out_i), p in zip(jobs, probs):
            if shots is None:
                est = expectation_from_probs(p, support)
            else:
                spt = max(1, int(shots) // self.n_traj)
                est = sampled_parity_expectation(p, spt, support,
                                                 self._generator)
            values[out_i] += coeff * float(est.mean())
        meta = [{"simulator": "pauli_trajectory", "n_traj": self.n_traj,
                 "shots": shots} for _ in circuits]
        return Job(EstimatorResult(values, meta))
