"""Tutorial z01: MLP debugging diagnostics.

Runner of ``docs/tutorials/z01_mlp_debug.py``: an MLP on MBL data with
its loss curves, the distribution of its outputs and the per-depth test
RMSE; the figures (where matplotlib is installed) go to ``out_dir`` (a
new temporary directory by default).
"""
import os
import tempfile

import numpy as np

from ..device.registry import get_device
from ..models.mlp import MLP1
from ..models.train import mlp_inputs, predict, train_mlp
from ..workflows.datasets import mbl_dataset
from ..workflows.figures import available
from ..workflows.mitigate import encode_dataset
from . import run


def main(device="cuda", fast=False, out_dir=None):
    out_dir = out_dir or tempfile.mkdtemp(prefix="mlp_debug_")
    os.makedirs(out_dir, exist_ok=True)
    dev = get_device("fake_lima")
    nq = 4
    # the reference's depth sweep (range(0, 10, 2)) becomes steps 1..5;
    # fast trims circuits and epochs, not the shape of the diagnostics
    train_ds = mbl_dataset(dev, num_qubits=nq, theta=0.05 * np.pi,
                           num_circuits=20 if fast else 500,
                           steps_range=(1, 5), seed=0, device=device)
    test_ds = mbl_dataset(dev, num_qubits=nq, theta=0.05 * np.pi,
                          num_circuits=10 if fast else 100,
                          steps_range=(1, 5), seed=1, device=device)
    X_train, y_train = encode_dataset(train_ds, dev)
    X_test, y_test = encode_dataset(test_ds, dev)
    print(f"features: {X_train.shape} (58-dim reference format)")
    model = MLP1(hidden_size=128, output_size=nq,
                 input_size=X_train.shape[1])
    state, history = train_mlp(model, X_train, y_train,
                               num_epochs=3 if fast else 30, batch_size=32,
                               seed=0, device=device)
    pred = predict(model, state, mlp_inputs,
                   {"X": np.asarray(X_test, np.float32)})
    y_test = np.asarray(y_test, np.float32)
    noisy = np.asarray(test_ds.noisy, np.float32)
    rmse_noisy = float(np.sqrt(np.mean((noisy - y_test) ** 2)))
    rmse_mit = float(np.sqrt(np.mean((pred - y_test) ** 2)))
    print(f"test RMSE: noisy {rmse_noisy:.4f} -> mitigated {rmse_mit:.4f}")

    # the debug diagnostics the reference script exists for
    if available():
        _debug_figures(history, y_test, noisy, pred, out_dir)
    else:
        print("matplotlib is not installed: the loss curves and the "
              "distribution figure are not drawn")
    steps = np.asarray([m["steps"] for m in test_ds.meta])
    print("per-depth test RMSE (noisy -> mitigated):")
    for s in sorted(set(steps.tolist())):
        sel = steps == s
        rn = float(np.sqrt(np.mean((noisy[sel] - y_test[sel]) ** 2)))
        rm = float(np.sqrt(np.mean((pred[sel] - y_test[sel]) ** 2)))
        print(f"  steps={s}: {rn:.4f} -> {rm:.4f}")
    print(f"debug figures written to {out_dir}")


def _debug_figures(history, y_test, noisy, pred, out_dir):
    """The loss curves and the distribution of ideal, noisy and mitigated
    values, as PNGs in ``out_dir``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5, 3.2))
    ax.plot(history["train_loss"], label="train_loss")
    ax.plot(history["val_loss"], label="val_loss")
    ax.set_yscale("log")
    ax.set_xlabel("epoch"), ax.set_ylabel("MSE"), ax.legend()
    fig.savefig(os.path.join(out_dir, "loss_curves.png"),
                bbox_inches="tight")
    plt.close(fig)
    fig, ax = plt.subplots(figsize=(5, 3.2))
    ax.hist([y_test.ravel(), noisy.ravel(), pred.ravel()], bins=30,
            label=["ideal", "noisy", "mitigated"])
    ax.set_title("Exp values distribution"), ax.legend()
    fig.savefig(os.path.join(out_dir, "exp_value_distribution.png"),
                bbox_inches="tight")
    plt.close(fig)


if __name__ == "__main__":
    run(main)
