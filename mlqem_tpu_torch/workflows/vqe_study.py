"""VQE mitigation workflows.

Counterpart of ``mlqem_tpu/workflows/vqe_study.py``. Rebuilds the
reference's VQE experiment stack; the Estimators and the forest's predict
run on ``device`` (the card unless the caller asks for the CPU), and the
transpile, encode and forest fit on the host:

* :func:`vqe_dataset` — ``vqe_data_gen_parallel.py``: TwoLocal(ry, cz,
  reps) ansatz with random parameter draws per Pauli term, ideal + noisy
  expectation values. One batched call of each Estimator replaces the
  reference's three ``multiprocessing.Pool`` passes (:100-126).
* :func:`train_vqe_processor` — ``vqe_rf.py:116-150``: RF on the encoded
  ansatz data, wrapped into a :class:`ModelProcessor`.
* :func:`vqe_mitigation_study` — ``vqe_rf.py:200-273``: run VQE with
  mitigated / noisy / ideal estimators + exact diagonalization and compare.
* :func:`h2_dissociation_curve` — ``vqe_rf_h2.py:255-318``: the bond-length
  sweep over the published H2 Hamiltonians.

:func:`vqe_dataset` and :func:`vqe_mitigation_study` take an optional
:class:`StageTimer` (``timer``), which times their stages to completion on
the card.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..apps.chemistry import load_h2_problems
from ..apps.vqe import VQE, exact_minimum_eigenvalue
from ..circuits.families import two_local_ansatz
from ..circuits.observables import PauliSum
from ..circuits.parameters import bind_parameters, circuit_parameters
from ..data.encoders import encode_data, encode_pauli_sum_op
from ..device.model import DeviceModel
from ..metrics import rmse
from ..mitigation.learning import ModelProcessor, learning
from ..models.forest import RandomForestRegressor
from ..primitives.estimator import IdealEstimator, NoisyEstimator
from ..transpile.lower import transpile
from ..utils.profiling import StageTimer

Device = Union[str, torch.device]


def _stage(timer: Optional[StageTimer], name: str):
    return timer.stage(name) if timer is not None else contextlib.nullcontext()


def vqe_dataset(device_model: DeviceModel, num_qubits: int = 2,
                reps: int = 3, entanglement: str = "full",
                paulis: Optional[Sequence[str]] = None,
                samples_per_pauli: int = 100,
                shots: Optional[int] = 10000,
                seed: int = 0, device: Device = "cuda",
                timer: Optional[StageTimer] = None) -> Dict:
    """(circuits, paulis, ideal, noisy, X, y) for random ansatz draws.

    Stages: "estimators" (both Estimator calls) and "encode" (host
    transpile + ``encode_data``)."""
    rng = np.random.default_rng(seed)
    ansatz = two_local_ansatz(num_qubits, reps=reps,
                              entanglement=entanglement)
    n_params = len(circuit_parameters(ansatz))
    if paulis is None:
        paulis = sorted({"I" * num_qubits, "Z" * num_qubits,
                         "X" * num_qubits, "I" * (num_qubits - 1) + "Z",
                         "Z" + "I" * (num_qubits - 1)})
    circuits, observables, metas = [], [], []
    for pauli in paulis:
        for _ in range(samples_per_pauli):
            theta = rng.uniform(-np.pi, np.pi, n_params)
            circuits.append(bind_parameters(ansatz, theta))
            observables.append(PauliSum([(pauli, 1.0)]))
            metas.append({"pauli": pauli, "theta": theta.tolist()})
    with _stage(timer, "estimators"):
        ideal = IdealEstimator(device=device).run(
            circuits, observables).result().values
        noisy = NoisyEstimator(device_model, shots=shots, seed=seed,
                               device=device).run(
            circuits, observables).result().values

    # encode in the ModelProcessor's per-term feature format
    with _stage(timer, "encode"):
        props = device_model.properties()
        X_rows = []
        for qc, obs, nv in zip(circuits, observables, noisy):
            tq = transpile(qc, basis=device_model.basis_gates)
            X, _ = encode_data([tq], props, [[0.0]], [[float(nv)]], 1,
                               meas_bases=encode_pauli_sum_op(obs))
            X_rows.append(X[0])
    return {
        "circuits": circuits, "observables": observables,
        "ideal": np.asarray(ideal), "noisy": np.asarray(noisy),
        "X": np.stack(X_rows), "y": np.asarray(ideal, np.float32),
        "meta": metas, "ansatz": ansatz,
    }


def train_vqe_processor(device_model: DeviceModel, data: Dict,
                        n_estimators: int = 300,
                        seed: int = 0, device: Device = "cuda"
                        ) -> Tuple[ModelProcessor, Dict]:
    """RF on the ansatz dataset → a deployable mitigation processor: the
    fit on the host, the predict on ``device``."""
    rf = RandomForestRegressor(n_estimators=n_estimators, random_state=seed,
                               device=device)
    n = data["X"].shape[0]
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    n_test = max(1, n // 5)
    te, tr = idx[:n_test], idx[n_test:]
    rf.fit(data["X"][tr], data["y"][tr])
    pred = rf.predict(data["X"][te])
    stats = {
        "rmse_noisy": float(rmse(data["noisy"][te], data["ideal"][te])),
        "rmse_mitigated": float(rmse(pred, data["ideal"][te])),
    }
    return ModelProcessor(rf, device_model, skip_transpile=False), stats


def vqe_mitigation_study(device_model: DeviceModel, operator: PauliSum,
                         processor: ModelProcessor,
                         reps: int = 3, entanglement: str = "full",
                         maxiter: int = 80, shots: Optional[int] = 10000,
                         seed: int = 0, device: Device = "cuda",
                         timer: Optional[StageTimer] = None) -> Dict:
    """VQE with mitigated / noisy / ideal estimators + exact reference.

    Stages: "arm ideal", "arm noisy", "arm mitigated"."""
    nq = operator.num_qubits
    ansatz = two_local_ansatz(nq, reps=reps, entanglement=entanglement)
    exact = exact_minimum_eigenvalue(operator)

    def arm(name, estimator):
        vqe = VQE(estimator, ansatz, optimizer="cobyla", maxiter=maxiter,
                  separate_observables=True, seed=seed)
        with _stage(timer, f"arm {name}"):
            return vqe.compute_minimum_eigenvalue(operator).eigenvalue

    mitigated_est = learning(NoisyEstimator, processor,
                             skip_transpile=True)(device_model, shots=shots,
                                                  seed=seed, device=device)
    out = {
        "exact": exact,
        "ideal": arm("ideal", IdealEstimator(device=device)),
        "noisy": arm("noisy", NoisyEstimator(device_model, shots=shots,
                                             seed=seed, device=device)),
        "mitigated": arm("mitigated", mitigated_est),
    }
    out["error_noisy"] = abs(out["noisy"] - exact)
    out["error_mitigated"] = abs(out["mitigated"] - exact)
    return out


# Published anchors from the reference's stored VQE run
# (docs/tutorials/results/vqe_h2.json, first four bond lengths): the
# mitigated VQE recovers the ideal curve from heavily biased noisy values.
PUBLISHED_H2 = {
    "bond_lengths": [0.2, 0.4, 0.5, 0.67],
    "ideal": [0.1749, -0.9123, -1.0265, -1.1174],
    "noisy": [0.5749, -0.6049, -0.7741, -0.8850],
    "mitigated": [0.1925, -0.9050, -1.0028, -1.1046],
}


def h2_dissociation_curve(device_model: DeviceModel,
                          bond_indices: Optional[Sequence[int]] = None,
                          samples_per_pauli: int = 80,
                          maxiter: int = 60,
                          shots: Optional[int] = 10000,
                          seed: int = 0, device: Device = "cuda"
                          ) -> List[Dict]:
    """Mitigated vs noisy vs ideal VQE energies across H2 bond lengths."""
    problems = load_h2_problems()
    if bond_indices is not None:
        problems = [problems[i] for i in bond_indices]
    data = vqe_dataset(device_model, num_qubits=2,
                       samples_per_pauli=samples_per_pauli, shots=shots,
                       seed=seed, device=device)
    processor, _ = train_vqe_processor(device_model, data, seed=seed,
                                       device=device)
    rows = []
    for length, fci, ham in problems:
        res = vqe_mitigation_study(device_model, ham, processor,
                                   maxiter=maxiter, shots=shots, seed=seed,
                                   device=device)
        rows.append({"bond_length": length, "fci": fci, **res})
    return rows
