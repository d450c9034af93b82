"""Port vs JAX package: the transfer-learning, stability and scalability
workflows (``workflows/transfer.py``); the paper-parity study is in
``tests/test_torch_paper_parity.py``.

Calibration snapshots and their feature drift are host numpy: equal. The
scalability sweep's labels come from the stabilizer tableau: equal. The
finetune starts from JAX-converted weights on the same batches: per-epoch
train losses within 1e-4.
"""
import jax
import numpy as np
import pytest

from mlqem_tpu.device.registry import configurable_device as j_configurable
from mlqem_tpu.device.registry import get_device as j_get_device
from mlqem_tpu.models.mlp import MLP1 as JMLP1
import mlqem_tpu.ops.stabilizer as jstab
from mlqem_tpu.workflows import datasets as jd
from mlqem_tpu.workflows import transfer as jtr

from mlqem_tpu_torch import MLP1, Circuit, convert, get_device
from mlqem_tpu_torch.workflows import datasets as td
from mlqem_tpu_torch.workflows import transfer as ttr

from port_fixtures import one_torch_thread  # noqa: F401

EPOCH_TOL = 1e-4
JDEV, DEV = j_get_device("fake_lima"), get_device("fake_lima")


def test_calibration_drift_matches_jax():
    got, want = ttr.calibration_snapshots(), jtr.calibration_snapshots()
    assert got == want and len(got["times"]) == 120
    for t in (0, 50, 119):
        assert ttr.device_at_time(DEV, got, t).to_dict() == \
            jtr.device_at_time(JDEV, want, t).to_dict()
    got, want = ttr.calibration_drift(), jtr.calibration_drift()
    assert got["times"] == want["times"]
    np.testing.assert_array_equal(got["stat_vectors"], want["stat_vectors"])
    assert got["drift_std"] == want["drift_std"]
    assert got["drift_rel"] == want["drift_rel"]


def test_scalability_sweep_labels_match_jax(monkeypatch):
    """Widths (5, 20, 100): the same composed circuits, the same labels."""
    want_labels = []
    real = jstab.batch_expectations

    def recording(circuits, obs):
        vals = real(circuits, obs)
        want_labels.append(vals)
        return vals

    monkeypatch.setattr(jstab, "batch_expectations", recording)
    kw = dict(qubit_counts=(5, 20, 100), depths=(1, 4), circuits_each=4)
    got = ttr.scalability_sweep(device="cpu", **kw)
    want = jtr.scalability_sweep(**kw)
    assert len(got) == len(want) == len(want_labels) == 6
    for g, w, labels in zip(got, want, want_labels):
        for k in ("n_qubits", "depth", "circuits", "mean_abs_label"):
            assert g[k] == w[k], k
        np.testing.assert_array_equal(g["labels"], labels)
        assert g["circuits_per_sec"] > 0


def _port_dataset(ds):
    return td.LabeledDataset([Circuit.from_dict(c.to_dict())
                              for c in ds.circuits], ds.ideal, ds.noisy,
                             ds.meta)


def test_finetune_from_jax_weights_matches_jax(monkeypatch):
    dev_b = j_configurable(4, seed=5)
    ds = jd.ising_dataset(dev_b, num_circuits=34, shots=None, seed=7)
    train_b, test_b = (jd.LabeledDataset(ds.circuits[sl], ds.ideal[sl],
                                         ds.noisy[sl], ds.meta[sl])
                       for sl in (slice(0, 24), slice(24, 34)))
    X, _ = jtr.encode_dataset(train_b, dev_b)
    jm = JMLP1(hidden_size=16, output_size=4)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3),
                                                 X[:1].astype(np.float32)))
    # JAX's per-step losses: its jitted step returns them fourth
    jlosses = []
    real_jit = jax.jit

    def recording_jit(fn, *a, **k):
        compiled = real_jit(fn, *a, **k)

        def run(*args):
            out = compiled(*args)
            if isinstance(out, tuple) and len(out) == 4:
                jlosses.append(float(out[3]))
            return out
        return run

    kw = dict(num_epochs=4, learning_rate=3e-3, seed=0)
    monkeypatch.setattr(jax, "jit", recording_jit)
    want = jtr.finetune(jm, variables, train_b, dev_b, test_b, **kw)
    monkeypatch.undo()
    model = MLP1(16, 4, input_size=X.shape[1])
    got = ttr.finetune(model, convert.state_dict_from_flax(variables),
                       _port_dataset(train_b),
                       ttr.DeviceModel.from_dict(dev_b.to_dict()),
                       _port_dataset(test_b), device="cpu", **kw)
    per_epoch = np.asarray(jlosses).reshape(kw["num_epochs"], -1).mean(1)
    np.testing.assert_allclose(got["train_loss"], per_epoch, atol=EPOCH_TOL,
                               rtol=0)
    assert got["train_loss"][-1] < got["train_loss"][0]
    for k in ("rmse_zero_shot", "rmse_finetuned", "rmse_noisy"):
        assert got[k] == pytest.approx(want[k], abs=EPOCH_TOL), k
