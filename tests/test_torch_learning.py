"""Port vs JAX package: the trainer, the learning and NGEM Estimators, and
the GNN workflows.

Training is held with every dropout off on both sides (flax's ``Dropout``
passes its input through; the port's dropout probabilities are 0), from
the same flax ``init`` carried over by ``convert.state_dict_from_flax``
(the port's ``init_params`` is patched to load it), on the same numpy
batches. Tolerances: one Adam step, every running statistic and every
parameter element whose gradient is at least 1e-6 ≤ 1e-5 (the rest
within Adam's step bound, 2·lr); three epochs, per-epoch train losses
≤ 1e-4; mitigated Estimator values ≤ 1e-5.
"""
import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from mlqem_tpu.circuits.circuit import Circuit as JCircuit
from mlqem_tpu.circuits.families import random_circuit as j_random_circuit
from mlqem_tpu.circuits.parameters import Parameter as JParameter
from mlqem_tpu.device.registry import get_device as j_get_device
from mlqem_tpu.mitigation import learning as jlearn
from mlqem_tpu.mitigation.ngem import GNNProcessor as JGNNProcessor
from mlqem_tpu.mitigation.ngem import ngem as j_ngem
from mlqem_tpu.models import gnn as jgnn
from mlqem_tpu.models import mlp as jmlp
from mlqem_tpu.models import train as jtrain
from mlqem_tpu.models.linear import LinearRegression as JLinear
from mlqem_tpu.primitives.estimator import NoisyEstimator as JNoisy
from mlqem_tpu.utils.rng import prng_key

from mlqem_tpu_torch import (Circuit, NoisyEstimator, PauliSum, ZNEEstimator,
                             ZNEStrategy, convert, get_device)
from mlqem_tpu_torch.circuits.parameters import Parameter
from mlqem_tpu_torch.data.generators import ExpValueEntry
from mlqem_tpu_torch.mitigation import learning as tlearn
from mlqem_tpu_torch.mitigation.ngem import ngem
from mlqem_tpu_torch.models import gnn, mlp
from mlqem_tpu_torch.models import train as ttrain
from mlqem_tpu_torch.workflows.gnn_training import (tomography_sweep,
                                                    train_gnn_mitigation)

from port_fixtures import one_torch_thread  # noqa: F401

STEP_TOL = 1e-5
EPOCH_TOL = 1e-4
EST_TOL = 1e-5


def graph_data(n, B_nodes=9, F=22, seed=0):
    """Padded graph arrays of n circuits' worth, self-loops included."""
    rng = np.random.default_rng(seed)
    N, E = B_nodes, 3 * B_nodes
    nv = rng.integers(4, N + 1, size=n)
    x = rng.normal(size=(n, N, F)).astype(np.float32)
    nm = np.arange(N)[None, :] < nv[:, None]
    x *= nm[..., None]
    ei = np.zeros((n, 2, E), np.int32)
    em = np.zeros((n, E), bool)
    for b in range(n):
        k = nv[b]
        src = list(range(k - 1)) + list(range(k))
        dst = list(range(1, k)) + list(range(k))
        ei[b, :, :len(src)] = [src, dst]
        em[b, :len(src)] = True
    data = {"x": x, "edge_index": ei, "edge_mask": em, "node_mask": nm,
            "noisy": rng.uniform(-1, 1, size=(n, 1)).astype(np.float32),
            "observable": rng.normal(size=(n, 17)).astype(np.float32),
            "circuit_depth": rng.uniform(1, 9, size=n).astype(np.float32)}
    y = (0.8 * data["noisy"][:, 0] + 0.1).astype(np.float32)
    return data, y


def jax_init_like_train_model(jm, data, seed):
    """The variables JAX's ``train_model`` starts from."""
    key = prng_key(seed)
    key, init_key, drop_key = jax.random.split(key, 3)
    example = {k: v[:1] for k, v in data.items()}
    return jax.jit(lambda *a: jm.init({"params": init_key,
                                       "dropout": drop_key}, *a,
                                      train=False))(
        *jtrain.gnn_inputs(example, np))


def train_both(monkeypatch, n, val_fraction, num_epochs, seed=0):
    """JAX's and the port's ``train_gnn`` on the same data from the same
    init, dropout off: (data, init, (variables, history), (state_dict,
    history))."""
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    data, y = graph_data(n, seed=seed)
    jm = jgnn.ExpValCircuitGraphModel3(15, 1)
    init = jax.tree.map(np.asarray, jax_init_like_train_model(jm, data, seed))
    monkeypatch.setattr(ttrain, "init_params", lambda model, gen: (
        model.load_state_dict(convert.state_dict_from_flax(init)),
        [setattr(m, "p", 0.0) for m in model.modules()
         if isinstance(m, mlp.Dropout)]))
    kw = dict(num_epochs=num_epochs, batch_size=11, learning_rate=1e-3,
              val_fraction=val_fraction, seed=seed)
    want = jtrain.train_gnn(jm, {**data, "y": y}, **kw)
    tm = gnn.ExpValCircuitGraphModel3(15, 1, num_node_features=22)
    got = ttrain.train_gnn(tm, {**data, "y": y}, device="cpu", **kw)
    return (data, y), init, want, got


# the parameters whose exact training-mode gradient is zero: the attention
# key biases (a softmax is shift-invariant) and the biases that feed a
# BatchNorm (it subtracts the batch mean)
NULL_GRADIENT = {"backbone.transformer1.k.bias", "backbone.transformer2.k.bias",
                 "backbone.pooling1.att_k.bias", "backbone.pooling2.att_k.bias",
                 "MLP3_0.Dense_0.bias", "MLP3_0.Dense_1.bias"}


def test_one_adam_step_matches_jax(monkeypatch):
    """11 graphs, no validation split, batch 11, one epoch: one Adam step on
    each side. Every running statistic, and every parameter element whose
    gradient is at least 1e-6, ≤ 1e-5. Adam's first step is lr·g/(|g| +
    1e-8), so below that rounding decides a step of up to lr on each side:
    those elements agree within 2·lr. They include the six parameters whose
    exact gradient is zero; the port's gradients are rounding noise there
    (≤ 1e-6 of the largest) and nowhere else."""
    (data, y), init, (jvars, jhist), (state, hist) = train_both(
        monkeypatch, 11, 0.0, 1)
    want = convert.state_dict_from_flax(jax.tree.map(np.asarray, jvars))
    assert want.keys() == state.keys()

    tm = gnn.ExpValCircuitGraphModel3(15, 1, num_node_features=22)
    tm.load_state_dict(convert.state_dict_from_flax(init))
    for m in tm.modules():
        if isinstance(m, mlp.Dropout):
            m.p = 0.0
    tm.train()
    batch = {k: torch.as_tensor(v) for k, v in data.items()}
    loss = torch.mean((tm(*ttrain.gnn_inputs(batch))
                       - torch.as_tensor(y)[:, None]) ** 2)
    loss.backward()
    grads = dict(tm.named_parameters())
    largest = max(p.grad.abs().max().item() for p in grads.values())
    for k, p in grads.items():
        assert (p.grad.abs().max().item() <= 1e-6 * largest) == \
            (k in NULL_GRADIENT), k
    for k, w in want.items():
        d = (state[k] - w).abs()
        if k in grads:
            tight = grads[k].grad.abs() >= 1e-6
            assert d[~tight].max().item() <= 2e-3 if (~tight).any() else True
            d = d[tight]
        assert d.numel() == 0 or d.max().item() <= STEP_TOL, (k, d.max())
    assert abs(hist["train_loss"][0] - jhist["train_loss"][0]) <= STEP_TOL


def test_three_epochs_match_jax(monkeypatch):
    """Two steps an epoch, three epochs: per-epoch train losses ≤ 1e-4 and
    the same learning-rate curve. The validation losses run in eval mode,
    where BatchNorm's running mean no longer cancels the biases feeding it:
    the rounding-decided steps Adam gave those (see the one-step test)
    move the validation loss by ~1e-4. With JAX's values for the six
    null-gradient parameters put into the port's best state, its
    validation loss equals JAX's best ≤ 1e-5."""
    (data, y), _, (jvars, jhist), (state, hist) = train_both(
        monkeypatch, 24, 0.1, 3)
    np.testing.assert_allclose(hist["train_loss"], jhist["train_loss"],
                               atol=EPOCH_TOL, rtol=0)
    assert hist["lr"] == jhist["lr"]
    want = convert.state_dict_from_flax(jax.tree.map(np.asarray, jvars))
    state = {**state, **{k: want[k] for k in NULL_GRADIENT}}
    tm = gnn.ExpValCircuitGraphModel3(15, 1, num_node_features=22)
    _, va = ttrain._split_train_val(24, 0.1, np.random.default_rng(0))
    pred = ttrain.predict(tm, state, ttrain.gnn_inputs,
                          {k: v[va] for k, v in data.items()})
    val = float(np.mean((pred[:, 0] - y[va]) ** 2))
    assert abs(val - min(jhist["val_loss"])) <= STEP_TOL
    assert np.argmin(hist["val_loss"]) == np.argmin(jhist["val_loss"])


def test_plateau_scheduler_matches_jax():
    losses = [1.0, 0.9, 0.95, 0.96, 0.97, 0.89, 0.9, 0.9, 0.9, 0.9, 0.9]
    got = ttrain.PlateauScheduler(factor=0.5, patience=2, min_lr=0.2)
    want = jtrain.PlateauScheduler(factor=0.5, patience=2, min_lr=0.2)
    lr_g = lr_w = 1.0
    for v in losses:
        lr_g, lr_w = got.step(v, lr_g), want.step(v, lr_w)
        assert lr_g == lr_w
    assert lr_g == 0.25


def test_checkpoint_roundtrip_and_trainer_outputs(tmp_path):
    """The trainer writes its best weights; they load into a fresh model
    and predict as the trained one; a seed gives the same run twice."""
    rng = np.random.default_rng(5)
    ideal = rng.uniform(-1, 1, size=(120, 1)).astype(np.float32)
    noisy = (ideal * 0.8 + rng.normal(0, 0.01, size=ideal.shape)
             ).astype(np.float32)
    path = str(tmp_path / "ckpt.pt")
    runs = []
    for _ in range(2):
        model = mlp.MLP1(16, 1, input_size=1)
        state, hist = ttrain.train_mlp(model, noisy, ideal, num_epochs=40,
                                       batch_size=32, learning_rate=3e-3,
                                       checkpoint_path=path, device="cpu")
        runs.append((model, state, hist))
    assert runs[0][2] == runs[1][2]
    model, state, hist = runs[0]
    assert min(hist["val_loss"]) < hist["val_loss"][0]
    loaded, extra = ttrain.load_checkpoint(path)
    assert extra["history"] == hist
    fresh = mlp.MLP1(16, 1, input_size=1)
    got = ttrain.predict(fresh, loaded, ttrain.mlp_inputs, {"X": noisy})
    want = ttrain.predict(model, None, ttrain.mlp_inputs, {"X": noisy})
    np.testing.assert_array_equal(got, want)
    ttrain.save_checkpoint(path, state, {"note": "x"})
    assert ttrain.load_checkpoint(path)[1] == {"note": "x"}
    gen = ttrain.fix_random_seed(3)
    assert torch.equal(torch.rand(2, generator=gen),
                       torch.rand(2, generator=torch.Generator(
                       ).manual_seed(3)))


# ---------------------------------------------------------------------------
# the learning and NGEM Estimators
# ---------------------------------------------------------------------------
def _circuits():
    """Four 4-qubit random circuits and one parametrized circuit, as JAX
    and port circuits, with multi-term observables."""
    jcs = [j_random_circuit(4, 3, seed=s) for s in range(4)]
    cs = [Circuit.from_dict(c.to_dict()) for c in jcs]
    ja, a = JParameter("a"), Parameter("a")
    jcs.append(JCircuit(4).h(0).rx(ja, 1).cx(0, 1).rz(ja * 0.5, 2).cx(2, 3))
    cs.append(Circuit(4).h(0).rx(a, 1).cx(0, 1).rz(a * 0.5, 2).cx(2, 3))
    obs = ["ZIII", "XXII", [("ZZIZ", 0.5), ("IYIX", -0.3)], "IIIZ",
           [("ZIZI", 1.0), ("XIII", 0.2)]]
    params = [(), (), (), (), (0.7,)]
    return jcs, cs, obs, params


def _run_both(jcls, tcls, pick=(0, 1, 2, 3, 4)):
    jcs, cs, obs, params = (
        [seq[i] for i in pick] for seq in _circuits())
    jdev, dev = j_get_device("fake_lima"), get_device("fake_lima")
    want = jcls(jdev).run(jcs, [jlearn.PauliSum(o) for o in obs],
                          params).result()
    got = tcls(dev, device="cpu").run(cs, [PauliSum(o) for o in obs],
                                      params).result()
    return got, want


def _mlp_pair():
    jm = jmlp.MLP3(30, 1)
    v = jax.jit(lambda x: jm.init({"params": jax.random.PRNGKey(2),
                                   "dropout": jax.random.PRNGKey(2)}, x,
                                  train=False))(np.ones((1, 72), np.float32))
    v = jax.tree.map(np.asarray, v)
    tm = mlp.MLP3(30, 1, input_size=72)
    tm.load_state_dict(convert.state_dict_from_flax(v))
    return jm, v, tm


def _linear_pair():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(120, 72))
    jl = JLinear().fit(X, X[:, 54] * 1.3 + 0.1 * X @ rng.normal(size=72))
    return jl, convert.linear_from_jax(jl.coef_, jl.intercept_, "cpu")


@pytest.mark.parametrize("kind", ["identity", "linear", "mlp"])
def test_learning_matches_jax(kind):
    """learning(NoisyEstimator) with the identity, a linear (scale) model
    and an MLP on the 72-dim fake_lima features: ≤ 1e-5 of JAX's."""
    jdev, dev = j_get_device("fake_lima"), get_device("fake_lima")
    if kind == "identity":
        jp, tp = jlearn.EmptyProcessor(), tlearn.EmptyProcessor()
    elif kind == "linear":
        jl, tl = _linear_pair()
        jp, tp = (jlearn.ModelProcessor(jl, jdev),
                  tlearn.ModelProcessor(tl, dev))
    else:
        jm, v, tm = _mlp_pair()
        jp = jlearn.FlaxModelProcessor(jm, v, jdev)
        tp = tlearn.TorchModelProcessor(tm, None, dev, device="cpu")
    jcls, tcls = (jlearn.learning(JNoisy, jp),
                  tlearn.learning(NoisyEstimator, tp))
    assert tcls.__name__ == jcls.__name__ == "LearningNoisyEstimator"
    got, want = _run_both(jcls, tcls)
    np.testing.assert_allclose(got.values, want.values, atol=EST_TOL,
                               rtol=0)
    np.testing.assert_allclose(
        [m["original_value"] for m in got.metadata],
        [m["original_value"] for m in want.metadata], atol=EST_TOL, rtol=0)
    if kind == "identity":
        assert [m["original_value"] for m in got.metadata] == \
            list(got.values)


def test_ngem_matches_jax():
    """ngem(NoisyEstimator) with the paper's GNN (hidden 15, heads 5/3)
    from the same weights: ≤ 1e-5 of JAX's; a ready processor passes
    through."""
    jm = jgnn.ExpValCircuitGraphModel3(15, 1)
    data, _ = graph_data(2, B_nodes=64)
    args = jtrain.gnn_inputs({k: v[:1] for k, v in data.items()}, np)
    v = jax.tree.map(np.asarray, jax.jit(lambda *a: jm.init(
        {"params": jax.random.PRNGKey(4), "dropout": jax.random.PRNGKey(4)},
        *a, train=False))(*args))
    tm = gnn.ExpValCircuitGraphModel3(15, 1, num_node_features=22)
    tm.load_state_dict(convert.state_dict_from_flax(v))
    jdev, dev = j_get_device("fake_lima"), get_device("fake_lima")
    # the JAX processor's forward, compiled once instead of run op by op
    jitted = type("Jitted", (), {"apply": staticmethod(jax.jit(
        jm.apply, static_argnames="train"))})()
    got, want = _run_both(
        j_ngem(JNoisy, JGNNProcessor(jitted, v, jdev), jdev),
        ngem(NoisyEstimator, tm, dev, device="cpu"))
    np.testing.assert_allclose(got.values, want.values, atol=EST_TOL,
                               rtol=0)
    assert ngem(NoisyEstimator, tlearn.EmptyProcessor(), dev).__name__ == \
        "NgemNoisyEstimator"


def test_ngem_value_is_the_batched_predict():
    """A GNN-mitigated value equals ``predict`` on the entry the processor
    builds (no self-loops, padding 64/160)."""
    dev = get_device("fake_lima")
    tm = gnn.ExpValCircuitGraphModel3(15, 1, num_node_features=22)
    _, cs, obs, params = _circuits()
    res = ngem(NoisyEstimator, tm, dev, skip_transpile=True, device="cpu")(
        dev, device="cpu").run(cs[:4], [PauliSum(o) for o in obs[:4]]
                               ).result()
    from mlqem_tpu_torch.data.graph import circuit_to_graph_data_json
    from mlqem_tpu_torch.data.encoders import encode_pauli_sum_op
    rows = []
    for c, o, m in zip(cs[:4], obs[:4], res.metadata):
        e = ExpValueEntry(circuit_to_graph_data_json(
            c, dev.properties(), True, True), encode_pauli_sum_op(
            PauliSum(o))[:1], 0.0, [m["original_value"]], c.depth())
        rows.append(e.to_arrays(64, 160))
    data = {k: np.stack([r[k] for r in rows]) for k in rows[0] if k != "y"}
    data["observable"] = data["observable"][:, 0]
    pred = ttrain.predict(tm, None, ttrain.gnn_inputs, data)[:, 0]
    np.testing.assert_allclose(res.values, pred, atol=EST_TOL, rtol=0)


def test_zne_processor_runs_zne_on_the_padded_observable():
    dev = get_device("fake_lima")
    strat = ZNEStrategy(noise_factors=(1, 3))
    zest = ZNEEstimator(NoisyEstimator(dev, readout=False, device="cpu"),
                        strat)
    qc = Circuit(2).h(0).cx(0, 1)
    proc = tlearn.ZNEProcessor(zest, dev, shots=None, zne_strategy=strat)
    got = tlearn.learning(NoisyEstimator, proc)(
        dev, device="cpu").run(qc, PauliSum("ZZ")).result().values
    want = zest.run([qc], [PauliSum("ZZ")]).result().values
    np.testing.assert_allclose(got, want, atol=1e-12)


# ---------------------------------------------------------------------------
# the workflows, on the CPU
# ---------------------------------------------------------------------------
def test_train_gnn_mitigation_runs_on_the_cpu(tmp_path):
    path = str(tmp_path / "gnn.pt")
    out = train_gnn_mitigation(get_device("fake_lima"), num_entries=30,
                               num_epochs=3, seed=0, checkpoint_path=path,
                               device="cpu")
    assert np.isfinite([out["rmse_mitigated"], out["rmse_noisy"]]).all()
    assert out["pad_nodes"] > 0 and len(out["history"]["val_loss"]) == 3
    assert len(out["test_index"]) == 6
    state, extra = ttrain.load_checkpoint(path)
    assert state.keys() == out["state_dict"].keys()


def test_tomography_sweep_improves_with_data():
    rows = tomography_sweep(get_device("fake_lima"), train_sizes=(16, 128),
                            test_size=40, seed=3, device="cpu")
    assert [r["train_size"] for r in rows] == [16, 128]
    assert rows[1]["rmse_mitigated"] < rows[0]["rmse_mitigated"]
    assert rows[0]["rmse_noisy"] == rows[1]["rmse_noisy"] > 0
