"""Generalization study: interpolation vs extrapolation (``07`` notebook).

Counterpart of ``mlqem_tpu/workflows/generalization.py``. Train the
mitigation model on a subset of the MBL parameter grid (interaction θ,
Trotter steps) and evaluate on held-out parameters INSIDE the training
range (interpolation) and OUTSIDE it (extrapolation) — the reference's
``07_generalization`` experiment shape.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from ..circuits.families import construct_mbl_circuit, generate_disorder
from ..device.model import DeviceModel
from ..metrics import rmse
from ..models.forest import RandomForestRegressor
from .datasets import Device, LabeledDataset, _zq_labels, noise_setting
from .mitigate import encode_dataset


def _mbl_at(device_model: DeviceModel, num_qubits: int, thetas, steps_list,
            per_config: int, shots, seed: int, device: Device
            ) -> LabeledDataset:
    rng = np.random.default_rng(seed)
    nm = noise_setting(device_model, "device", seed=seed)
    circuits, meta = [], []
    for theta in thetas:
        for steps in steps_list:
            for _ in range(per_config):
                disorder = generate_disorder(
                    num_qubits, seed=int(rng.integers(2 ** 31)))
                circuits.append(construct_mbl_circuit(
                    num_qubits, disorder, theta, steps, measure=False))
                meta.append({"theta": theta, "steps": steps})
    ideal, noisy = _zq_labels(circuits, device_model, nm, shots, seed,
                              device=device)
    return LabeledDataset(circuits, ideal, noisy, meta)


def generalization_study(device_model: DeviceModel,
                         num_qubits: int = 4,
                         train_thetas: Sequence[float] = (0.05, 0.15),
                         interp_theta: float = 0.10,
                         extrap_theta: float = 0.30,
                         steps_list: Sequence[int] = (1, 2, 3),
                         per_config: int = 12,
                         shots=None,
                         seed: int = 0,
                         device: Device = "cuda") -> Dict:
    """Train at θ ∈ train_thetas·π, test at interp/extrap θ·π; labels and
    the forest's predictions run on ``device``."""
    t = [x * np.pi for x in train_thetas]
    train = _mbl_at(device_model, num_qubits, t, steps_list, per_config,
                    shots, seed, device)
    interp = _mbl_at(device_model, num_qubits, [interp_theta * np.pi],
                     steps_list, per_config, shots, seed + 1, device)
    extrap = _mbl_at(device_model, num_qubits, [extrap_theta * np.pi],
                     steps_list, per_config, shots, seed + 2, device)

    rf = RandomForestRegressor(n_estimators=100, random_state=seed,
                               device=device)
    Xtr, ytr = encode_dataset(train, device_model)
    rf.fit(Xtr, ytr)

    def eval_on(ds):
        X, _ = encode_dataset(ds, device_model)
        pred = rf.predict(X)
        return {"rmse_noisy": float(rmse(ds.noisy, ds.ideal)),
                "rmse_mitigated": float(rmse(pred, ds.ideal))}

    return {
        "train_thetas_pi": list(train_thetas),
        "interpolation": {"theta_pi": interp_theta, **eval_on(interp)},
        "extrapolation": {"theta_pi": extrap_theta, **eval_on(extrap)},
    }
