"""GNN mitigation workflow: graph datasets → trained ExpValCircuitGraph.

Counterpart of ``mlqem_tpu/workflows/gnn_training.py``. The ``train_gnn``
harness (``docs/tutorials/__ml_models.py:100-263``) end to end:
ExpValueEntry datasets → padded graph arrays → ExpValCircuitGraphModel3
training (Adam + ReduceLROnPlateau, checkpointing) → RMSE eval → optional
``ngem()`` deployment behind the Estimator API.

Plus :func:`train_gnn_mbl`, the paper's GNN task on MBL circuits with
per-qubit ⟨Z⟩ labels, and the ``h18_tomography`` workflow: random
measurement bases and the training-set-size sweep (2^4 … 2^11).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..circuits.circuit import Circuit
from ..data.encoders import encode_data
from ..data.generators import ExpValueEntry, generate_exp_val_dataset
from ..data.loaders import ExpValDataset
from ..device.model import DeviceModel
from ..metrics import rmse
from ..models.forest import RandomForestRegressor
from ..models.gnn import ExpValCircuitGraphModel3
from ..models.train import gnn_inputs, predict, train_gnn
from .datasets import mbl_dataset
from .mitigate import _split, graph_encode_dataset


def train_gnn_mitigation(device_model: DeviceModel,
                         entries: Optional[List[ExpValueEntry]] = None,
                         num_entries: int = 200,
                         n_qubits: int = 4,
                         circuit_depth: int = 3,
                         hidden_channels: int = 15,
                         num_epochs: int = 60,
                         test_fraction: float = 0.2,
                         seed: int = 0,
                         checkpoint_path: Optional[str] = None,
                         device: Union[str, torch.device] = "cuda") -> Dict:
    """Generate (or take) an entry dataset, train the paper GNN on
    ``device``, eval RMSE."""
    if entries is None:
        entries = generate_exp_val_dataset(
            device_model, n_qubits=n_qubits, circuit_depth=circuit_depth,
            num_entries=num_entries, seed=seed, device=device)
    ds = ExpValDataset(entries)
    arrays = dict(ds.arrays)
    y = arrays.pop("y")
    # observables may vary in term count per entry — pool to fixed width
    obs = arrays["observable"]
    if obs.ndim == 3:
        arrays["observable"] = obs.mean(axis=1)

    rng = np.random.default_rng(seed)
    n = y.shape[0]
    idx = rng.permutation(n)
    n_test = max(1, int(n * test_fraction))
    te, tr = idx[:n_test], idx[n_test:]
    tr_arrays = {k: v[tr] for k, v in arrays.items()}
    te_arrays = {k: v[te] for k, v in arrays.items()}

    model = ExpValCircuitGraphModel3(
        hidden_channels=hidden_channels, exp_value_size=1,
        num_node_features=arrays["x"].shape[-1])
    state_dict, history = train_gnn(
        model, {**tr_arrays, "y": y[tr]}, num_epochs=num_epochs,
        batch_size=32, learning_rate=1e-3, seed=seed,
        checkpoint_path=checkpoint_path, device=device)
    pred = predict(model, state_dict, gnn_inputs, te_arrays)[:, 0]
    noisy = arrays["noisy"][te][:, 0]
    return {
        "rmse_noisy": float(rmse(noisy, y[te])),
        "rmse_mitigated": float(rmse(pred, y[te])),
        "history": history,
        "model": model,
        "state_dict": state_dict,
        "pad_nodes": ds.max_nodes,
        "pad_edges": ds.max_edges,
        "test_index": te,
    }


def train_gnn_mbl(device_model: DeviceModel,
                  num_qubits: int = 4,
                  num_circuits: int = 600,
                  steps_range=(1, 4),
                  hidden_channels: int = 15,
                  dropout: float = 0.1,
                  num_epochs: int = 200,
                  learning_rate: float = 2e-3,
                  test_fraction: float = 0.15,
                  shots=None,
                  seed: int = 0,
                  checkpoint_path=None,
                  device: Union[str, torch.device] = "cuda") -> Dict:
    """The paper's GNN task: per-qubit ⟨Z⟩ mitigation on MBL circuits.

    (The reference's best-GNN configuration, ``gnn.py:313-317`` — dropout
    0.3 there assumes thousands of training circuits; 0.1 works at
    hundreds.) The dataset's labels and the training run on ``device``.
    """
    ds = mbl_dataset(device_model, num_qubits=num_qubits,
                     num_circuits=num_circuits, steps_range=steps_range,
                     shots=shots, seed=seed, device=device)
    data = graph_encode_dataset(ds, device_model, standardize=False)
    y = ds.ideal.astype(np.float32)
    te, tr = _split(len(ds), test_fraction, seed)

    model = ExpValCircuitGraphModel3(
        hidden_channels=hidden_channels, exp_value_size=num_qubits,
        dropout=dropout, num_node_features=data["x"].shape[-1])
    state_dict, history = train_gnn(
        model, {**{k: v[tr] for k, v in data.items()}, "y": y[tr]},
        num_epochs=num_epochs, batch_size=32, learning_rate=learning_rate,
        seed=seed, checkpoint_path=checkpoint_path, device=device)
    pred = predict(model, state_dict, gnn_inputs,
                   {k: v[te] for k, v in data.items()})
    return {
        "rmse_noisy": float(rmse(ds.noisy[te], y[te])),
        "rmse_mitigated": float(rmse(pred, y[te])),
        "history": history,
        "model": model,
        "state_dict": state_dict,
        "test_index": te,
    }


def tomography_features(entries: Sequence[ExpValueEntry], properties: dict
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Flat features of ``h18_tomography``: each entry's circuit encoded
    with its noisy value and its (random) measurement basis appended, the
    rows ``ModelProcessor`` builds. Returns (X, y) float32."""
    X_rows, y_rows = [], []
    for e in entries:
        qc = Circuit.from_dict(e.circuit)
        X, _ = encode_data([qc], properties, [[0.0]],
                           [[e.noisy_exp_values[0]]], 1,
                           meas_bases=[e.observable[0]])
        X_rows.append(X[0])
        y_rows.append(e.ideal_exp_value)
    return np.stack(X_rows), np.asarray(y_rows, np.float32)


def tomography_sweep(device_model: DeviceModel,
                     train_sizes: Sequence[int] = (16, 32, 64, 128),
                     n_qubits: int = 3,
                     circuit_depth: int = 3,
                     pauli_terms: int = 1,
                     test_size: int = 64,
                     seed: int = 7,
                     device: Union[str, torch.device] = "cuda"
                     ) -> List[Dict]:
    """``h18_tomography``: random observable bases; RF accuracy vs
    training-set size (the reference sweeps 2^4 … 2^11). The dataset's
    labels and the forests' predictions run on ``device``."""
    max_n = max(train_sizes) + test_size
    entries = generate_exp_val_dataset(
        device_model, n_qubits=n_qubits, circuit_depth=circuit_depth,
        pauli_terms=pauli_terms, num_entries=max_n, seed=seed, device=device)
    X, y = tomography_features(entries, device_model.properties())
    test_X, test_y = X[-test_size:], y[-test_size:]
    test_noisy = np.array([e.noisy_exp_values[0]
                           for e in entries[-test_size:]])

    out = []
    for n_train in train_sizes:
        rf = RandomForestRegressor(n_estimators=100, random_state=seed,
                                   device=device)
        rf.fit(X[:n_train], y[:n_train])
        pred = rf.predict(test_X)
        out.append({
            "train_size": int(n_train),
            "rmse_mitigated": float(rmse(pred, test_y)),
            "rmse_noisy": float(rmse(test_noisy, test_y)),
        })
    return out
