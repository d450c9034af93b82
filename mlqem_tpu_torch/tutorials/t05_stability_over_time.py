"""Tutorial 05: stability over time.

Runner of ``docs/tutorials/05_stability_over_time.py``: the calibration
drift table of ibmq_lima, then an MLP trained at t=0, evaluated at a
drifted snapshot and fine-tuned back.
"""
from ..device.registry import get_device
from ..models.mlp import MLP1
from ..models.train import train_mlp
from ..workflows.datasets import ising_dataset
from ..workflows.mitigate import encode_dataset
from ..workflows.transfer import (calibration_drift, calibration_snapshots,
                                  device_at_time, finetune)
from . import run


def main(device="cuda", fast=False):
    base = get_device("fake_lima")
    drift = calibration_drift("ibmq_lima")
    names = ["cx_err", "id_err", "sx_err", "x_err", "rz_err", "readout",
             "t1", "t2"]
    print(f"{len(drift['times'])} snapshots "
          f"({drift['times'][0]} .. {drift['times'][-1]})")
    print("relative drift (std/mean) per device stat:")
    for n, r in zip(names, drift["drift_rel"]):
        print(f"  {n:8s} {r:7.4f}")

    # train at t=0, evaluate at a drifted snapshot, fine-tune back
    snaps = calibration_snapshots("ibmq_lima")
    dev_t0 = device_at_time(base, snaps, 0)
    dev_t100 = device_at_time(base, snaps, 100)
    n_circ = 16 if fast else 100
    ds_t0 = ising_dataset(dev_t0, num_circuits=n_circ, shots=None, seed=0,
                          device=device)
    X0, y0 = encode_dataset(ds_t0, dev_t0)
    model = MLP1(hidden_size=32, output_size=4, input_size=X0.shape[1])
    state, _ = train_mlp(model, X0, y0, num_epochs=3 if fast else 80,
                         batch_size=32, learning_rate=3e-3, seed=0,
                         device=device)
    ds_tr = ising_dataset(dev_t100, num_circuits=n_circ // 2, shots=None,
                          seed=1, device=device)
    ds_te = ising_dataset(dev_t100, num_circuits=n_circ // 2, shots=None,
                          seed=2, device=device)
    out = finetune(model, state, ds_tr, dev_t100, ds_te,
                   num_epochs=3 if fast else 50, seed=0, device=device)
    print(f"drifted device (t=100): zero-shot rmse "
          f"{out['rmse_zero_shot']:.4f} -> finetuned "
          f"{out['rmse_finetuned']:.4f} (noisy baseline "
          f"{out['rmse_noisy']:.4f})")


if __name__ == "__main__":
    run(main)
