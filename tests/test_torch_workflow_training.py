"""Port vs JAX package: the trained arms of the workflows (MLP1 and the GNN
of the model zoo, ``model_comparison``, ``train_gnn_mbl``) and the
generalization study.

Training is held with every dropout off on both sides, from the JAX init
carried over by ``convert.state_dict_from_flax``: the per-epoch train
losses ≤ 1e-4. The datasets themselves are held to JAX's in
``tests/test_torch_workflows.py``.
"""
import flax.linen as fnn
import jax
import numpy as np
import pytest

import mlqem_tpu.models.train as jtrain
from mlqem_tpu.models.mlp import MLP1 as JMLP1
from mlqem_tpu.device.registry import get_device as j_get_device
from mlqem_tpu.utils.rng import prng_key
from mlqem_tpu.workflows import datasets as jd
from mlqem_tpu.workflows import generalization as jgen
from mlqem_tpu.workflows import gnn_training as jgnn_training
from mlqem_tpu.workflows import mitigate as jmit

import mlqem_tpu_torch.models.train as ttrain
from mlqem_tpu_torch import MLP1, Circuit, convert, get_device
from mlqem_tpu_torch.models import mlp as tmlp
from mlqem_tpu_torch.workflows import datasets as td
from mlqem_tpu_torch.workflows import generalization as tgen
from mlqem_tpu_torch.workflows import gnn_training as tgnn_training
from mlqem_tpu_torch.workflows import mitigate as tmit

from port_fixtures import one_torch_thread  # noqa: F401

LABEL_TOL = 1e-5
EPOCH_TOL = 1e-4

JDEV, DEV = j_get_device("fake_lima"), get_device("fake_lima")


def _pair(n):
    """One ising dataset in both packages (the port's holds JAX's labels)."""
    want = jd.ising_dataset(JDEV, num_circuits=n, steps_range=(0, 5),
                            shots=None, seed=4)
    got = td.LabeledDataset([Circuit.from_dict(c.to_dict())
                             for c in want.circuits], want.ideal.copy(),
                            want.noisy.copy(), want.meta)
    return got, want


def _record(monkeypatch, module, name, store):
    """Wrap ``module.name`` so its returned history lands in ``store``."""
    fn = getattr(module, name)

    def wrapped(*a, **k):
        out = fn(*a, **k)
        store.append(out[1])
        return out

    monkeypatch.setattr(module, name, wrapped)


def _load_jax_init(monkeypatch, jm, inputs_fn, sample, seed=0):
    """The port's ``init_params`` loads what JAX's ``train_model`` starts
    from at ``seed`` (``sample`` holds one example row), with every
    dropout off."""
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    key, init_key, drop_key = jax.random.split(prng_key(seed), 3)
    init = jax.tree.map(np.asarray, jax.jit(lambda *a: jm.init(
        {"params": init_key, "dropout": drop_key}, *a, train=False))(
        *inputs_fn(sample, np)))
    monkeypatch.setattr(ttrain, "init_params", lambda model, gen: (
        model.load_state_dict(convert.state_dict_from_flax(init)),
        [setattr(m, "p", 0.0) for m in model.modules()
         if isinstance(m, tmlp.Dropout)]))


def test_mlp_arm_trains_as_jax(monkeypatch):
    got, want = _pair(40)
    X, _ = jmit.encode_dataset(want, JDEV)
    jm = JMLP1(hidden_size=64, output_size=4)
    _load_jax_init(monkeypatch, jm, jtrain.mlp_inputs, {"X": X[:1]})
    hist, jhist = [], []
    _record(monkeypatch, tmit, "train_mlp", hist)
    _record(monkeypatch, jtrain, "train_mlp", jhist)
    kw = dict(seed=0, num_epochs=3, batch_size=8, learning_rate=3e-3)
    out = tmit.train_mitigation_model(
        MLP1(64, 4, input_size=X.shape[1]), got, DEV, device="cpu", **kw)
    jout = jmit.train_mitigation_model(jm, want, JDEV, **kw)
    np.testing.assert_allclose(hist[0]["train_loss"], jhist[0]["train_loss"],
                               atol=EPOCH_TOL, rtol=0)
    assert hist[0]["lr"] == jhist[0]["lr"]
    assert out["rmse_noisy"] == pytest.approx(jout["rmse_noisy"], abs=1e-6)
    assert out["state_dict"] is not None


def _mbl_pair():
    """The MBL dataset both GNN tests train on (3 qubits, 14 circuits: one
    shape, so JAX compiles its train step once for both)."""
    want = jd.mbl_dataset(JDEV, num_qubits=3, num_circuits=14, shots=None,
                          seed=0)
    got = td.LabeledDataset([Circuit.from_dict(c.to_dict())
                             for c in want.circuits], want.ideal.copy(),
                            want.noisy.copy(), want.meta)
    return got, want


def test_gnn_arm_trains_as_jax(monkeypatch):
    from mlqem_tpu.models.gnn import ExpValCircuitGraphModel3 as JGNN

    got, want = _mbl_pair()
    te, tr = tmit._split(len(want), 0.2, 0)
    data = jmit.graph_encode_dataset(want, JDEV, stats_indices=tr)
    _load_jax_init(monkeypatch, JGNN(hidden_channels=15, exp_value_size=3,
                                     dropout=0.0), jtrain.gnn_inputs,
                   {k: v[tr][:1] for k, v in data.items()})
    hist, jhist = [], []
    _record(monkeypatch, tmit, "train_gnn", hist)
    _record(monkeypatch, jtrain, "train_gnn", jhist)
    out = tmit.train_gnn_on_dataset(got, DEV, num_epochs=2, device="cpu")
    jout = jmit.train_gnn_on_dataset(want, JDEV, num_epochs=2)
    np.testing.assert_allclose(hist[0]["train_loss"], jhist[0]["train_loss"],
                               atol=EPOCH_TOL, rtol=0)
    assert out["test_indices"] == jout["test_indices"] == te.tolist()
    assert out["rmse_noisy"] == pytest.approx(jout["rmse_noisy"], abs=1e-6)
    assert np.isfinite(out["rmse_mitigated"])


def test_model_comparison_matches_jax(monkeypatch):
    """The OLS and forest arms equal JAX's (≤ 1e-6), MLP1 trains as JAX's
    from the same init, and the GNN arm gets the same call (it is held to
    JAX's in ``test_gnn_arm_trains_as_jax``; here both sides' are
    recorded stubs)."""
    got, want = _pair(24)
    X, _ = jmit.encode_dataset(want, JDEV)
    _load_jax_init(monkeypatch, JMLP1(hidden_size=64, output_size=4),
                   jtrain.mlp_inputs, {"X": X[:1]}, seed=1)
    calls = []

    def gnn_stub(ds, device_model, **kw):
        kw.pop("device", None)
        calls.append(kw)
        return {"rmse_noisy": 0.0, "rmse_mitigated": 0.0}

    monkeypatch.setattr(tmit, "train_gnn_on_dataset", gnn_stub)
    monkeypatch.setattr(jmit, "train_gnn_on_dataset", gnn_stub)
    hist, jhist = [], []
    _record(monkeypatch, tmit, "train_mlp", hist)
    _record(monkeypatch, jtrain, "train_mlp", jhist)
    table = tmit.model_comparison(got, DEV, seed=1, mlp_epochs=2,
                                  gnn_epochs=3, device="cpu")
    jtable = jmit.model_comparison(want, JDEV, seed=1, mlp_epochs=2,
                                   gnn_epochs=3)
    assert set(table) == set(jtable) == {"ols", "random_forest", "mlp1",
                                         "gnn"}
    assert calls == [dict(seed=1, num_epochs=3)] * 2
    for arm in ("ols", "random_forest", "mlp1"):
        assert table[arm]["test_indices"] == jtable[arm]["test_indices"]
        np.testing.assert_allclose(table[arm]["rmse_noisy"],
                                   jtable[arm]["rmse_noisy"], atol=1e-6,
                                   rtol=0)
    for arm in ("ols", "random_forest"):
        np.testing.assert_allclose(table[arm]["rmse_mitigated"],
                                   jtable[arm]["rmse_mitigated"], atol=1e-6,
                                   rtol=0, err_msg=arm)
    np.testing.assert_allclose(hist[0]["train_loss"], jhist[0]["train_loss"],
                               atol=EPOCH_TOL, rtol=0)


def test_generalization_study_matches_jax(monkeypatch):
    """The forest splits on the noisy features, where a label difference
    of 1e-7 can flip a near-tied split. So each dataset's labels are held
    to JAX's (≤ 1e-5) and JAX's are handed on; everything after them
    (encoding, the forest, the RMSEs) is then held to 1e-6."""
    from mlqem_tpu.circuits.circuit import Circuit as JCircuit

    real = tgen._zq_labels
    seeds = []

    def checked(circuits, device_model, nm, shots, seed, device):
        got = real(circuits, device_model, nm, shots, seed, device=device)
        want = jd._zq_labels([JCircuit.from_dict(c.to_dict())
                              for c in circuits], JDEV,
                             jd.noise_setting(JDEV, "device"), shots, seed)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=LABEL_TOL, rtol=0)
        seeds.append(seed)
        return want

    monkeypatch.setattr(tgen, "_zq_labels", checked)
    kw = dict(num_qubits=3, steps_list=(1, 2), per_config=3, seed=0)
    got = tgen.generalization_study(DEV, device="cpu", **kw)
    want = jgen.generalization_study(JDEV, **kw)
    assert seeds == [0, 1, 2]
    assert got.keys() == want.keys()
    assert got["train_thetas_pi"] == want["train_thetas_pi"]
    for arm in ("interpolation", "extrapolation"):
        assert got[arm].keys() == want[arm].keys()
        for k, v in want[arm].items():
            np.testing.assert_allclose(got[arm][k], v, atol=1e-6,
                                       rtol=0, err_msg=(arm, k))


def test_train_gnn_mbl_matches_jax(monkeypatch):
    from mlqem_tpu.data.graph import circuit_to_graph_data_json, stack_graphs
    from mlqem_tpu.models.gnn import ExpValCircuitGraphModel3 as JGNN

    _, ds = _mbl_pair()
    props = JDEV.properties()
    batch = stack_graphs([circuit_to_graph_data_json(c, props, True, True)
                          for c in ds.circuits])
    sample = {k: batch[k][:1] for k in ("x", "edge_index", "edge_mask",
                                        "node_mask")}
    sample.update(noisy=ds.noisy[:1].astype(np.float32),
                  observable=np.zeros((1, 17), np.float32),
                  circuit_depth=np.ones(1, np.float32))
    _load_jax_init(monkeypatch, JGNN(hidden_channels=15, exp_value_size=3,
                                     dropout=0.1), jtrain.gnn_inputs, sample)
    hist, jhist = [], []
    _record(monkeypatch, tgnn_training, "train_gnn", hist)
    _record(monkeypatch, jgnn_training, "train_gnn", jhist)
    kw = dict(num_qubits=3, num_circuits=14, num_epochs=2, seed=0)
    out = tgnn_training.train_gnn_mbl(DEV, device="cpu", **kw)
    jout = jgnn_training.train_gnn_mbl(JDEV, **kw)
    np.testing.assert_allclose(hist[0]["train_loss"], jhist[0]["train_loss"],
                               atol=EPOCH_TOL, rtol=0)
    assert out["rmse_noisy"] == pytest.approx(jout["rmse_noisy"],
                                              abs=LABEL_TOL)
    assert len(out["test_index"]) == 2
