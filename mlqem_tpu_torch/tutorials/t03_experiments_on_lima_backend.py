"""Tutorial 03: the model zoo, ZNE and mimicry on the lima backend.

Runner of ``docs/tutorials/03_experiments_on_lima_backend.py``: the
OLS / RF / MLP / GNN comparison, digital ZNE and its RF mimic, and the
best model behind the Estimator.
"""
from ..circuits.observables import single_z
from ..device.registry import get_device
from ..mitigation.learning import ModelProcessor, learning
from ..models.forest import RandomForestRegressor
from ..primitives.estimator import NoisyEstimator
from ..workflows.datasets import ising_dataset
from ..workflows.mitigate import model_comparison, train_zne_mimic, zne_batch
from . import run


def main(device="cuda", fast=False):
    dev = get_device("fake_lima")
    ds = ising_dataset(dev, num_circuits=12 if fast else 80, shots=10000,
                       seed=0, device=device)
    # model zoo comparison (h10/h12/h15/h17/h34 shape, all four arms)
    table = model_comparison(ds, dev, seed=0, mlp_epochs=3 if fast else 80,
                             gnn_epochs=3 if fast else 400, device=device)
    for name, row in table.items():
        print(f"{name:14s} rmse: noisy {row['rmse_noisy']:.4f} -> "
              f"mitigated {row['rmse_mitigated']:.4f}")

    # digital ZNE baseline + mimicry (h16/h19 shape)
    zne_vals = zne_batch(ds, dev, shots=10000, seed=1, device=device)
    mimic = train_zne_mimic(RandomForestRegressor(100, random_state=0,
                                                  device=device), ds,
                            dev, zne_values=zne_vals, seed=0, device=device)
    print("mimic vs zne rmse:", round(mimic["rmse_mimic_vs_zne"], 4))

    # deploy the best model behind the Estimator primitive
    best = table["random_forest"]["model"]
    est = learning(NoisyEstimator, ModelProcessor(best, dev,
                                                  skip_transpile=True),
                   skip_transpile=True)(dev, shots=10000, device=device)
    res = est.run(ds.circuits[0], single_z(0, 4)).result()
    print("mitigated:", res.values[0], "| original:",
          res.metadata[0]["original_value"])


if __name__ == "__main__":
    run(main)
