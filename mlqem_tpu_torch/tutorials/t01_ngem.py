"""Tutorial 01, ngem: GNN-ensemble mitigation behind the Estimator.

Runner of ``docs/tutorials/01_ngem.py``: an expectation-value dataset
under fake_lima noise, the GCN/Cheb/SAGE ensemble (``NgemEnsembleModel``)
and its test RMSE against the noisy baseline, then the trained model
behind the Estimator with ``ngem()``.
"""
import numpy as np

from ..circuits.circuit import Circuit
from ..circuits.observables import single_z
from ..data.generators import generate_exp_val_dataset
from ..data.loaders import ExpValDataset
from ..device.registry import get_device
from ..metrics import rmse
from ..mitigation.ngem import ngem
from ..models.gnn import NgemEnsembleModel
from ..models.train import gnn_inputs, predict, train_gnn
from ..primitives.estimator import NoisyEstimator
from . import run


def main(device="cuda", fast=False):
    dev = get_device("fake_lima")
    # random 4q circuits, ideal + noisy single-Z labels
    entries = generate_exp_val_dataset(dev, n_qubits=4, circuit_depth=3,
                                       num_entries=20 if fast else 200,
                                       seed=0, device=device)
    ds = ExpValDataset(entries)
    arrays = dict(ds.arrays)
    y = arrays.pop("y")
    obs = arrays["observable"]
    if obs.ndim == 3:                  # pool variable-term observables
        arrays["observable"] = obs.mean(axis=1)
    rng = np.random.default_rng(0)
    idx = rng.permutation(y.shape[0])
    n_test = max(1, y.shape[0] // 5)
    te, tr = idx[:n_test], idx[n_test:]

    # the 01_ngem ensemble: parallel GCN / Cheb / SAGE stacks
    model = NgemEnsembleModel(
        hidden_channels=16, exp_value_size=1, dropout=0.0,
        num_node_features=arrays["x"].shape[-1],
        observable_size=arrays["observable"].shape[-1])
    state, _ = train_gnn(
        model, {**{k: v[tr] for k, v in arrays.items()}, "y": y[tr]},
        num_epochs=4 if fast else 150, batch_size=32, learning_rate=1e-3,
        seed=0, device=device)
    pred = predict(model, state, gnn_inputs,
                   {k: v[te] for k, v in arrays.items()})
    noisy_te = arrays["noisy"][te][:, :1]
    print(f"ngem ensemble RMSE: noisy {rmse(noisy_te, y[te]):.4f} -> "
          f"mitigated {rmse(pred, y[te]):.4f}")

    # deployment: an Estimator whose results come back GNN-mitigated
    NgemEstimator = ngem(NoisyEstimator, model, dev, state_dict=state,
                         pad_nodes=ds.max_nodes, pad_edges=ds.max_edges,
                         skip_transpile=True, device=device)
    est = NgemEstimator(dev, shots=10000, device=device)
    qc = Circuit.from_dict(entries[0].circuit)
    res = est.run(qc, single_z(0, 4)).result()
    print("deployed ngem estimator:", float(res.values[0]),
          "| unmitigated:", res.metadata[0]["original_value"])


if __name__ == "__main__":
    run(main)
