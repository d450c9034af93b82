"""Tutorial 02: the data generators.

Runner of ``docs/tutorials/02_data_generation.py``: random-circuit graph
entries through a JSON round trip, Ising datasets under three noise
settings, the template label pipeline and an MBL dataset.
"""
import os
import tempfile

import numpy as np

from ..data.generators import generate_exp_val_dataset
from ..data.loaders import ExpValDataset, save_entries_json
from ..device.registry import get_device
from ..parallel.datagen import IsingLabelPipeline
from ..workflows.datasets import ising_dataset, mbl_dataset
from . import run


def main(device="cuda", fast=False):
    dev = get_device("fake_lima")
    # random-circuit graph entries (JSON round-trips with reference sets)
    entries = generate_exp_val_dataset(dev, n_qubits=4, circuit_depth=3,
                                       num_entries=10 if fast else 20,
                                       seed=0, device=device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "entries.json")
        save_entries_json(entries, path)
        ds = ExpValDataset(path)
    print("graph dataset arrays:", {k: v.shape for k, v in ds.arrays.items()})

    # the workhorse: Ising Trotter datasets under three noise settings
    for noise in ("device", "coherent", "no_readout"):
        d = ising_dataset(dev, num_circuits=10 if fast else 20, noise=noise,
                          shots=10000, seed=1, device=device)
        err = float(np.sqrt(np.mean((d.noisy - d.ideal) ** 2)))
        print(f"ising[{noise}]: rmse(noisy, ideal) = {err:.4f}")

    # the template pipeline (the bench path)
    pipe = IsingLabelPipeline(dev, nq=4, steps=3, dt=0.5, shots=10000,
                              method="trajectory", n_traj=64, device=device)
    ideal, noisy = pipe.generate(np.linspace(0.1, 0.5, 32), seed=0)
    print("pipeline labels:", ideal.shape, noisy.shape)

    # MBL Floquet with charge-imbalance targets
    mbl = mbl_dataset(dev, num_qubits=4, num_circuits=4 if fast else 10,
                      shots=None, seed=2, device=device)
    print("mbl ideal[0]:", np.round(mbl.ideal[0], 3))


if __name__ == "__main__":
    run(main)
