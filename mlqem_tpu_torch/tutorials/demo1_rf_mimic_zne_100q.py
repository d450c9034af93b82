"""demo1: 100-qubit RF mimicry of ZNE.

Runner of ``docs/demos/demo1_rf_mimic_zne_100q.py``: the reference's full
depth (100 qubits, 10 Trotter steps) on the exact light-cone engine at
the calibrated noise scale; ``fast``: 10 qubits, 1 step, 6 circuits a
step and 4 / 2 error realizations.
"""
import numpy as np

from ..device.registry import configurable_device
from ..workflows.demos import DEMO1_CALIBRATED_SCALE, demo1_zne_mimic_100q
from . import run


def main(device="cuda", fast=False):
    if fast:
        nq = 10
        out = demo1_zne_mimic_100q(
            configurable_device(nq, seed=1), nq=nq, num_steps=1,
            qubits=(0, 3, 5, 7, 9), num_circ_per_step=6,
            train_per_step=2, num_twirls=4, num_twirls_amp=2,
            noise_scale=DEMO1_CALIBRATED_SCALE, seed=0, device=device)
    else:
        out = demo1_zne_mimic_100q(
            configurable_device(100, seed=1), nq=100, num_steps=10,
            noise_scale=DEMO1_CALIBRATED_SCALE, seed=0, device=device)
    print("qubits:", out["qubits"])
    print(f"RMSE noisy : {out['rmse_noisy']:.5f}")
    print(f"RMSE ZNE   : {out['rmse_zne']:.5f}")
    print(f"RMSE mimic : {out['rmse_mimic']:.5f} "
          f"({out['rmse_noisy'] / out['rmse_mimic']:.2f}x better than "
          f"noisy)")
    print("per-qubit noisy :", np.round(out["rmse_per_qubit_noisy"], 4))
    print("per-qubit mimic :", np.round(out["rmse_per_qubit_mimic"], 4))
    print("max truncation discard:", round(out["max_truncation_discard"], 4))


if __name__ == "__main__":
    run(main)
