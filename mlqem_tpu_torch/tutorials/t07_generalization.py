"""Tutorial 07: generalization across Hamiltonian parameters.

Runner of ``docs/tutorials/07_generalization.py``: interpolation and
extrapolation RMSE of a mitigator trained on two MBL angles.
"""
from ..device.registry import get_device
from ..workflows.generalization import generalization_study
from . import run


def main(device="cuda", fast=False):
    dev = get_device("fake_lima")
    out = generalization_study(dev, num_qubits=4,
                               per_config=3 if fast else 12, shots=None,
                               seed=0, device=device)
    for split in ("interpolation", "extrapolation"):
        row = out[split]
        print(f"{split:14s} θ={row['theta_pi']}π: "
              f"noisy {row['rmse_noisy']:.4f} -> "
              f"mitigated {row['rmse_mitigated']:.4f}")
    gap = (out["extrapolation"]["rmse_mitigated"]
           - out["interpolation"]["rmse_mitigated"])
    print(f"generalization gap (extrap - interp): {gap:+.4f}")


if __name__ == "__main__":
    run(main)
