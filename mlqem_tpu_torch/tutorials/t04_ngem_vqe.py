"""Tutorial 04: VQE on the learning Estimator.

Runner of ``docs/tutorials/04_ngem_vqe.py``: the ansatz dataset, the
forest processor, and H2 near equilibrium through ideal, noisy and
mitigated VQE.
"""
from ..apps.chemistry import load_h2_problems
from ..device.registry import get_device
from ..workflows.vqe_study import (train_vqe_processor, vqe_dataset,
                                   vqe_mitigation_study)
from . import run


def main(device="cuda", fast=False):
    dev = get_device("fake_lima")
    data = vqe_dataset(dev, samples_per_pauli=4 if fast else 60,
                       shots=10000, seed=0, device=device)
    processor, stats = train_vqe_processor(
        dev, data, n_estimators=20 if fast else 300, device=device)
    print("processor training:", stats)
    length, fci, ham = load_h2_problems()[4]   # near-equilibrium H2
    out = vqe_mitigation_study(dev, ham, processor,
                               maxiter=10 if fast else 60, shots=10000,
                               device=device)
    print(f"H2 @ {length} A: exact {out['exact']:.5f}")
    for arm in ("ideal", "noisy", "mitigated"):
        print(f"  {arm:9s}: {out[arm]:.5f}")
    print(f"error: noisy {out['error_noisy']:.5f} -> "
          f"mitigated {out['error_mitigated']:.5f}")


if __name__ == "__main__":
    run(main)
