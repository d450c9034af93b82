"""Mitigation workflows: model training, ZNE batch runs, mimicry.

Counterpart of ``mlqem_tpu/workflows/mitigate.py``. Rebuilds the
reference's experiment drivers:

* :func:`encode_dataset` + :func:`train_mitigation_model` — the
  ``h10/h12/h15`` model-zoo sweep: identical flat features, swap regressor.
* :func:`zne_batch` — the ``zne_parallel.py`` runner: ZNE over a whole
  dataset in batched device calls instead of a process pool.
* :func:`train_zne_mimic` — ``h19_mimic_zne`` / demo1's core move: train a
  model on (noisy → ZNE-mitigated) labels so mitigation no longer needs
  classically simulable ideal values.
* :func:`model_comparison` — the RMSE table of OLS / RF / MLP1 / GNN.

Labels, training and predictions run on ``device`` (the card unless the
caller asks for the CPU); the splits are numpy permutations from ``seed``,
as in the JAX package. A trained torch model comes back as its
``state_dict`` where the JAX package returns flax ``variables``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from ..data.encoders import encode_data
from ..data.graph import circuit_to_graph_data_json, stack_graphs
from ..device.model import DeviceModel
from ..metrics import rmse
from ..mitigation.zne import ZNEStrategy
from ..models.forest import RandomForestRegressor
from ..models.gnn import ExpValCircuitGraphModel3
from ..models.linear import LinearRegression
from ..models.mlp import MLP1
from ..models.train import gnn_inputs, mlp_inputs, predict, train_gnn, \
    train_mlp
from .datasets import (Device, LabeledDataset, _select_logical, _zq_labels,
                       noise_setting)


def encode_dataset(ds: LabeledDataset, device_model: DeviceModel
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(X, y) in the reference's flat-feature format; y = ideal labels."""
    props = device_model.properties()
    nq = ds.ideal.shape[1]
    return encode_data(ds.circuits, props, ds.ideal.tolist(),
                       ds.noisy.tolist(), nq)


def graph_encode_dataset(ds: LabeledDataset, device_model: DeviceModel,
                         max_nodes: Optional[int] = None,
                         max_edges: Optional[int] = None,
                         standardize: bool = True,
                         stats_count: Optional[int] = None,
                         stats_indices=None) -> Dict[str, np.ndarray]:
    """Padded graph-array dict for the GNNs (per-qubit ⟨Z⟩ task).

    Same schema :func:`~.gnn_training.train_gnn_mbl` feeds
    ``ExpValCircuitGraphModel3``: DAG node/edge arrays + masks, noisy
    expvals, zero observable block, circuit depth.

    ``standardize`` z-scores the node features (over real nodes) and the
    circuit depth — the raw features mix scales from t1/t2 ≈ 1e-4 s to
    depths of tens, which stalls GNN training. Restrict the statistics to
    the train rows to avoid test leakage: ``stats_count`` uses the first N
    entries (train block first), ``stats_indices`` an arbitrary index
    array (random splits).
    """
    props = device_model.properties()
    graphs = [circuit_to_graph_data_json(c, props, True, True)
              for c in ds.circuits]
    batch = stack_graphs(graphs, max_nodes=max_nodes, max_edges=max_edges)
    x = batch["x"].astype(np.float32)
    depth = np.array([c.depth() for c in ds.circuits], np.float32)
    if standardize:
        if stats_indices is not None:
            sel = np.asarray(stats_indices)
        else:
            ns = stats_count if stats_count is not None else x.shape[0]
            sel = np.arange(ns)
        real = batch["node_mask"][sel].astype(bool)
        flat = x[sel][real]                              # [N_real, F]
        mu = flat.mean(axis=0)
        sd = flat.std(axis=0) + 1e-8
        x = ((x - mu) / sd) * batch["node_mask"][..., None]
        dmu, dsd = depth[sel].mean(), depth[sel].std() + 1e-8
        depth = (depth - dmu) / dsd
    return {
        "x": x.astype(np.float32), "edge_index": batch["edge_index"],
        "edge_mask": batch["edge_mask"], "node_mask": batch["node_mask"],
        "noisy": ds.noisy.astype(np.float32),
        "observable": np.zeros((len(ds), 17), np.float32),
        "circuit_depth": depth.astype(np.float32),
    }


def _split(n: int, test_fraction: float, seed: int
           ) -> Tuple[np.ndarray, np.ndarray]:
    """(test, train) indices: the JAX package's permutation split."""
    idx = np.random.default_rng(seed).permutation(n)
    n_test = max(1, int(n * test_fraction))
    return idx[:n_test], idx[n_test:]


def train_gnn_on_dataset(ds: LabeledDataset, device_model: DeviceModel,
                         test_fraction: float = 0.2, seed: int = 0,
                         hidden_channels: int = 15, dropout: float = 0.0,
                         num_epochs: int = 400,
                         learning_rate: float = 2e-3,
                         device: Device = "cuda") -> Dict:
    """GNN arm of the model zoo: same split protocol as
    :func:`train_mitigation_model`, graph features instead of flat ones.

    Matches the reference's model-comparison GNN
    (``docs/tutorials/gnn.py:178-224``, used by h17/h33/h34).
    """
    y = ds.ideal.astype(np.float32)
    te, tr = _split(len(ds), test_fraction, seed)
    # standardization statistics from the TRAIN rows only (no test leakage)
    data = graph_encode_dataset(ds, device_model, stats_indices=tr)
    model = ExpValCircuitGraphModel3(
        hidden_channels=hidden_channels, exp_value_size=ds.ideal.shape[1],
        dropout=dropout, num_node_features=data["x"].shape[-1])
    state_dict, history = train_gnn(
        model, {**{k: v[tr] for k, v in data.items()}, "y": y[tr]},
        num_epochs=num_epochs, batch_size=32, learning_rate=learning_rate,
        seed=seed, device=device)
    pred = predict(model, state_dict, gnn_inputs,
                   {k: v[te] for k, v in data.items()})
    return {
        "rmse_noisy": float(rmse(ds.noisy[te], y[te])),
        "rmse_mitigated": float(rmse(pred, y[te])),
        "rmse_per_qubit_noisy": rmse(ds.noisy[te], y[te], axis=0).tolist(),
        "rmse_per_qubit_mitigated": rmse(pred, y[te], axis=0).tolist(),
        "test_indices": te.tolist(),
        "history": history,
        "model": model,
        "state_dict": state_dict,
    }


def train_mitigation_model(model, ds: LabeledDataset,
                           device_model: DeviceModel,
                           test_fraction: float = 0.2, seed: int = 0,
                           device: Device = "cuda",
                           **train_kwargs) -> Dict:
    """Train any regressor on (features → ideal) and report RMSEs.

    ``model``: anything with fit/predict (linear, forest) or a torch
    module (trained on ``device`` via ``train_mlp``; it takes the feature
    width as ``input_size``).
    """
    X, y = encode_dataset(ds, device_model)
    te, tr = _split(len(ds), test_fraction, seed)
    if hasattr(model, "fit"):
        model.fit(X[tr], y[tr])
        pred = np.asarray(model.predict(X[te]))
        state_dict = None
    else:
        state_dict, _ = train_mlp(model, X[tr], y[tr], seed=seed,
                                  device=device, **train_kwargs)
        pred = predict(model, state_dict, mlp_inputs, {"X": X[te]})
    if pred.ndim == 1:
        pred = pred[:, None]
    return {
        "rmse_noisy": float(rmse(ds.noisy[te], ds.ideal[te])),
        "rmse_mitigated": float(rmse(pred, ds.ideal[te])),
        "rmse_per_qubit_noisy": rmse(ds.noisy[te], ds.ideal[te],
                                     axis=0).tolist(),
        "rmse_per_qubit_mitigated": rmse(pred, ds.ideal[te],
                                         axis=0).tolist(),
        "test_indices": te.tolist(),
        "model": model,
        "state_dict": state_dict,
    }


def zne_batch(ds: LabeledDataset, device_model: DeviceModel,
              strategy: Optional[ZNEStrategy] = None,
              noise: str = "device", shots: Optional[int] = 10000,
              seed: int = 0,
              num_twirls: Optional[int] = None,
              device: Device = "cuda") -> np.ndarray:
    """ZNE-mitigated per-qubit Z values for every circuit: [B, nq].

    The ``zne_parallel.py`` equivalent — ONE batched evolution of all
    B × len(noise_factors) × max(num_twirls, 1) folded (and optionally
    Pauli-twirled) circuits serves every qubit's Z; all qubits read a
    shared shot record per folded circuit (hardware counts semantics).

    ``num_twirls`` (or ``strategy.num_twirls``) > 0 composes twirling
    with folding — the hardware pipeline's resilience_level=2 semantics:
    twirl instances of each folded circuit are averaged before
    extrapolation. Required for coherent noise. ``shots`` is per twirl
    instance.
    """
    nm = noise_setting(device_model, noise, seed=seed)
    strategy = strategy or ZNEStrategy(noise_factors=(1, 3))
    if num_twirls is not None:
        strategy = dataclasses.replace(strategy, num_twirls=num_twirls)
    nfs = list(strategy.noise_factors)
    n_tw = max(strategy.num_twirls, 1)
    folded = [inst
              for ci, qc in enumerate(ds.circuits)
              for nf in nfs
              for inst in strategy.amplify_twirled(qc, nf,
                                                   seed=seed + ci)]
    _, noisy = _zq_labels(folded, device_model, nm, shots, seed,
                          ideal=False, device=device)
    nq = ds.ideal.shape[1]
    # logical qubits through each circuit's final layout (folding and
    # twirling keep the metadata; the identity for unrouted circuits)
    noisy = _select_logical(noisy, folded, nq)
    # twirl-average, then extrapolate (demo1's reshape(...).mean(-1) step)
    vals = noisy.reshape(len(ds.circuits), len(nfs), n_tw, nq).mean(axis=2)
    out = np.empty((len(ds.circuits), nq))
    for i in range(vals.shape[0]):
        for q in range(nq):
            out[i, q] = strategy.extrapolator.extrapolate(
                nfs, vals[i, :, q])
    return out


def train_zne_mimic(model, ds: LabeledDataset, device_model: DeviceModel,
                    zne_values: Optional[np.ndarray] = None,
                    strategy: Optional[ZNEStrategy] = None,
                    test_fraction: float = 0.2, seed: int = 0,
                    shots: Optional[int] = 10000,
                    device: Device = "cuda") -> Dict:
    """Mimicry: learn the ZNE *output* instead of the ideal value.

    This removes the need for classically simulable labels — the 100Q
    hardware pipeline's trick (h19/h26/h33, demo1). Reports RMSE of the
    mimic vs actual ZNE and (for a fit/predict model, when ideal labels
    exist) vs ideal.
    """
    if zne_values is None:
        zne_values = zne_batch(ds, device_model, strategy, shots=shots,
                               seed=seed, device=device)
    mimic_ds = LabeledDataset(ds.circuits, zne_values, ds.noisy, ds.meta)
    out = train_mitigation_model(model, mimic_ds, device_model,
                                 test_fraction=test_fraction, seed=seed,
                                 device=device)
    te = np.asarray(out["test_indices"])
    X, _ = encode_dataset(ds, device_model)
    pred = np.asarray(out["model"].predict(X[te])) \
        if out["state_dict"] is None else None
    result = {
        "rmse_mimic_vs_zne": out["rmse_mitigated"],
        "rmse_noisy_vs_zne": out["rmse_noisy"],
        "zne_values": zne_values,
        "model": out["model"],
        "state_dict": out["state_dict"],
    }
    if ds.ideal is not None and pred is not None:
        result["rmse_mimic_vs_ideal"] = float(rmse(pred, ds.ideal[te]))
        result["rmse_zne_vs_ideal"] = float(
            rmse(zne_values[te], ds.ideal[te]))
        result["rmse_noisy_vs_ideal"] = float(
            rmse(ds.noisy[te], ds.ideal[te]))
    return result


def model_comparison(ds: LabeledDataset, device_model: DeviceModel,
                     seed: int = 0,
                     mlp_epochs: int = 150,
                     gnn_epochs: int = 400,
                     device: Device = "cuda") -> Dict[str, Dict]:
    """The h34/h17 model-vs-model table: OLS / RF / MLP1 / GNN on one
    dataset (all four arms of the reference's comparison, same split)."""
    nq = ds.ideal.shape[1]
    n_features = encode_dataset(ds, device_model)[0].shape[1]
    out = {}
    out["ols"] = train_mitigation_model(LinearRegression(device=device), ds,
                                        device_model, seed=seed,
                                        device=device)
    out["random_forest"] = train_mitigation_model(
        RandomForestRegressor(n_estimators=100, random_state=seed,
                              device=device), ds, device_model, seed=seed,
        device=device)
    out["mlp1"] = train_mitigation_model(
        MLP1(hidden_size=64, output_size=nq, input_size=n_features), ds,
        device_model, seed=seed, device=device, num_epochs=mlp_epochs,
        batch_size=32, learning_rate=3e-3)
    out["gnn"] = train_gnn_on_dataset(ds, device_model, seed=seed,
                                      num_epochs=gnn_epochs, device=device)
    return out
