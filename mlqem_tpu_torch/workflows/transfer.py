"""Transfer-learning + stability workflows.

Counterpart of ``mlqem_tpu/workflows/transfer.py``:

* :func:`finetune` — ``h08_finetuning``: train on device A, load the
  checkpoint, continue Adam on a (small) device-B dataset; compare
  zero-shot vs finetuned RMSE on B (the FakeLima → FakeMontreal study).
* :func:`calibration_drift` — ``05_stability_over_time`` /
  ``fetch_device_params``: device calibration snapshots over time (the
  JAX package's Lima/Montreal fixtures carry the real 2023 time series,
  read here by path) and the resulting feature-vector drift.
* :func:`scalability_sweep` — ``06_scalability``: stabilizer-method data
  generation across n_qubits ∈ {5, 20, 50, 100, 200, 400}, the tableaux
  on ``device``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import registry
from ..device.model import DeviceModel, GateProps, QubitProps
from ..device.registry import get_device
from ..metrics import rmse
from .datasets import Device, LabeledDataset
from .mitigate import encode_dataset


def finetune(model: torch.nn.Module,
             state_dict: Optional[Dict[str, torch.Tensor]],
             train_ds_b: LabeledDataset, device_b: DeviceModel,
             test_ds_b: LabeledDataset, num_epochs: int = 30,
             learning_rate: float = 3e-4, seed: int = 0,
             device: Device = "cuda") -> Dict:
    """Continue training a checkpointed flat-feature model on device-B data.

    ``state_dict`` (loaded first when not None) is the checkpoint trained
    on device A; ``device_b`` is device B's calibration and ``device`` the
    torch device the model trains on. Adam (optax's update, eps 1e-8) over
    batches of 32 in the order of numpy ``default_rng(seed)``
    permutations, as the JAX package draws them; dropout masks come from a
    ``torch.Generator`` seeded with ``seed``. Returns the zero-shot and
    finetuned RMSEs on the B test set (h08's comparison), the per-epoch
    mean train loss and the finetuned weights.
    """
    from ..models.mlp import Dropout
    from ..models.train import mlp_inputs, predict, train_step

    Xb, yb = encode_dataset(train_ds_b, device_b)
    Xt, yt = encode_dataset(test_ds_b, device_b)
    device = torch.device(device)
    model.to(device)
    if state_dict is not None:
        model.load_state_dict(state_dict)

    def predict_b():
        pred = predict(model, None, mlp_inputs, {"X": Xt.astype(np.float32)})
        return pred if pred.ndim == 2 else pred[:, None]

    rmse_zero = float(rmse(predict_b(), yt))

    gen = torch.Generator(device=device).manual_seed(seed)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = gen
    optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate,
                                 eps=1e-8)
    X_dev = torch.as_tensor(Xb, dtype=torch.float32, device=device)
    y2 = yb if yb.ndim == 2 else yb[:, None]
    y_dev = torch.as_tensor(y2, dtype=torch.float32, device=device)
    rng = np.random.default_rng(seed)
    n = Xb.shape[0]
    train_loss = []
    for _ in range(num_epochs):
        order = rng.permutation(n)
        losses = []
        for s in range(0, n, 32):
            sel = torch.as_tensor(order[s:s + 32], device=device)
            losses.append(train_step(model, optimizer, (X_dev[sel],),
                                     y_dev[sel]))
        train_loss.append(float(torch.stack(losses).mean()))
    return {
        "rmse_zero_shot": rmse_zero,
        "rmse_finetuned": float(rmse(predict_b(), yt)),
        "rmse_noisy": float(rmse(test_ds_b.noisy, test_ds_b.ideal)),
        "train_loss": train_loss,
        "state_dict": {k: v.detach().clone()
                       for k, v in model.state_dict().items()},
    }


def calibration_snapshots(name: str = "ibmq_lima") -> Dict:
    """The real calibration time series (device_params parity), read by
    path from the JAX package's device fixtures."""
    path = os.path.join(registry._FIXTURE_DIR, f"{name}_timeseries.json")
    with open(path) as f:
        return json.load(f)


def device_at_time(base: DeviceModel, series: Dict, t_index: int
                   ) -> DeviceModel:
    """Device model with calibration values from time snapshot ``t_index``."""
    dev = DeviceModel.from_dict(base.to_dict())
    for q in range(dev.num_qubits):
        dev.qubits[q] = QubitProps(
            t1=series["t1"][str(q)][t_index],
            t2=series["t2"][str(q)][t_index],
            readout_error=series["readout_err"][str(q)][t_index])
    for pair, errs in series["cnot_err"].items():
        a, b = pair.split("_")
        key = f"cx_{a}_{b}"
        if key in dev.gates:
            dev.gates[key] = GateProps(errs[t_index],
                                       dev.gates[key].gate_length)
    for q in range(dev.num_qubits):
        for g, errs in (("sx", series["sx_err"]), ("x", series["x_err"])):
            key = f"{g}_{q}"
            if key in dev.gates:
                dev.gates[key] = GateProps(errs[str(q)][t_index],
                                           dev.gates[key].gate_length)
    return dev


def calibration_drift(name: str = "ibmq_lima",
                      base_device: str = "fake_lima") -> Dict:
    """Stability-over-time study: feature drift across real snapshots."""
    from ..data.encoders import device_stat_vector

    series = calibration_snapshots(name)
    base = get_device(base_device)
    vecs = np.stack([device_stat_vector(
        device_at_time(base, series, t).properties())
        for t in range(len(series["times"]))])
    return {
        "times": series["times"],
        "stat_vectors": vecs,
        "drift_std": vecs.std(axis=0).tolist(),
        "drift_rel": (vecs.std(axis=0) / np.abs(vecs.mean(axis=0) + 1e-12)
                      ).tolist(),
    }


def scalability_sweep(qubit_counts: Sequence[int] = (5, 20, 50, 100,
                                                    200, 400),
                      depths: Sequence[int] = (1, 4, 7),
                      circuits_each: int = 20,
                      block_qubits: int = 5,
                      seed: int = 0,
                      device: Device = "cuda") -> List[Dict]:
    """Stabilizer-method data-gen sweep (``06_scalability`` shape):
    composed Clifford circuits at growing widths, single-Z labels, timing
    (host circuit draws and decomposition included, ending in the labels'
    host copy). ``labels`` holds each row's ⟨Z_0⟩ values.
    """
    from ..circuits.families import generate_composed_clifford
    from ..circuits.observables import single_z
    from ..ops.stabilizer import batch_expectations

    rng = np.random.default_rng(seed)
    results = []
    for nq in qubit_counts:
        blocks = max(1, nq // block_qubits)
        for depth in depths:
            t0 = time.time()
            circs = [generate_composed_clifford(
                block_qubits, blocks, depth,
                seed=int(rng.integers(2 ** 31)))
                for _ in range(circuits_each)]
            vals = batch_expectations(
                circs, single_z(0, blocks * block_qubits), device=device)
            dt = time.time() - t0
            results.append({
                "n_qubits": blocks * block_qubits,
                "depth": depth,
                "circuits": circuits_each,
                "seconds": dt,
                "circuits_per_sec": circuits_each / dt,
                "mean_abs_label": float(np.mean(np.abs(vals))),
                "labels": vals.tolist(),
            })
    return results
