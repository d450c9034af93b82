"""demo2: 4-qubit TFIM Trotter mitigation.

Runner of ``docs/demos/demo2_ising_4q.py``: an RF trained on randomized
(J, steps) circuits, evaluated on the paper configuration's 10-step
sweep (150 training circuits, 10,000 shots); ``fast``: 2 steps and 12
training circuits.
"""
import numpy as np

from ..workflows.demos import demo2_ising_4q
from . import run


def main(device="cuda", fast=False):
    out = demo2_ising_4q(num_steps=2 if fast else 10,
                         num_train=12 if fast else 150, shots=10000, seed=0,
                         device=device)
    print(f"RMSE noisy     : {out['rmse_noisy']:.5f}")
    print(f"RMSE mitigated : {out['rmse_mitigated']:.5f}")
    print("per-qubit noisy    :", np.round(out["rmse_per_qubit_noisy"], 4))
    print("per-qubit mitigated:",
          np.round(out["rmse_per_qubit_mitigated"], 4))
    print("L2 vs ideal per step (noisy)    :",
          np.round(out["l2_per_step_noisy"], 4))
    print("L2 vs ideal per step (mitigated):",
          np.round(out["l2_per_step_mitigated"], 4))


if __name__ == "__main__":
    run(main)
