"""Port vs JAX package: the model zoo (linear, forest, MLPs, GNNs).

Weights cross as ``convert.state_dict_from_flax`` of a flax ``init``; the
forest and the linear fit are the same host numpy code on both sides.
Tolerances: every eval or train-mode forward ≤ 1e-5 and BatchNorm running
statistics ≤ 1e-6; forest and linear predictions ≤ 1e-6 and identical
trees; adjacency and pooling masks exact. The JAX forwards run under
``jax.jit``.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlqem_tpu.models import forest as jforest
from mlqem_tpu.models import gnn as jgnn
from mlqem_tpu.models import mlp as jmlp
from mlqem_tpu.models.linear import LinearRegression as JLinear

from mlqem_tpu_torch import convert
from mlqem_tpu_torch.models import gnn, mlp
from mlqem_tpu_torch.models.forest import RandomForestRegressor
from mlqem_tpu_torch.models.linear import LinearRegression

from port_fixtures import one_torch_thread  # noqa: F401

TOL = 1e-5
STATS_TOL = 1e-6


def no_dropout(monkeypatch, model=None):
    """Every dropout off: flax's ``Dropout`` passes its input through, and
    the port's dropout probabilities are 0."""
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, *a, **k: x)
    if model is not None:
        for m in model.modules():
            if isinstance(m, mlp.Dropout):
                m.p = 0.0


def graph_batch(B=6, N=10, F=22, K=1, obs_width=17, seed=0):
    """Random padded graphs: a chain of op→op edges plus random extras, a
    self-loop per node (duplicates included), 4..N valid nodes."""
    rng = np.random.default_rng(seed)
    n_valid = rng.integers(4, N + 1, size=B)
    n_valid[0] = N
    x = rng.normal(size=(B, N, F)).astype(np.float32)
    node_mask = np.arange(N)[None, :] < n_valid[:, None]
    x *= node_mask[..., None]
    E = 3 * N
    ei = np.zeros((B, 2, E), np.int32)
    em = np.zeros((B, E), bool)
    for b in range(B):
        n = n_valid[b]
        src = list(range(n - 1)) + list(rng.integers(0, n, size=n // 2)) \
            + list(range(n))
        dst = list(range(1, n)) + list(rng.integers(0, n, size=n // 2)) \
            + list(range(n))
        ei[b, :, :len(src)] = [src, dst]
        em[b, :len(src)] = True
    return {
        "x": x, "edge_index": ei, "edge_mask": em, "node_mask": node_mask,
        "noisy": rng.uniform(-1, 1, size=(B, K)).astype(np.float32),
        "observable": rng.normal(size=(B, obs_width)).astype(np.float32),
        "circuit_depth": rng.uniform(1, 9, size=B).astype(np.float32),
    }


def jax_args(d):
    adj = jgnn.edge_index_to_adj(jnp.asarray(d["edge_index"]),
                                 jnp.asarray(d["edge_mask"]), d["x"].shape[1])
    return (jnp.asarray(d["noisy"]), jnp.asarray(d["observable"]),
            jnp.asarray(d["circuit_depth"]), jnp.asarray(d["x"]), adj,
            jnp.asarray(d["node_mask"]))


def torch_args(d):
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    adj = gnn.edge_index_to_adj(t["edge_index"], t["edge_mask"],
                                t["x"].shape[1])
    return (t["noisy"], t["observable"], t["circuit_depth"], t["x"], adj,
            t["node_mask"])


def port_from_flax(model, variables):
    model.load_state_dict(convert.state_dict_from_flax(
        jax.tree.map(np.asarray, variables)))
    return model


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max()) if a.size else 0.0
    assert err <= tol, err


# ---------------------------------------------------------------------------
# linear and forest
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("alpha,intercept,K", [(0.0, True, 0), (0.5, True, 3),
                                               (0.0, False, 2)])
def test_linear_matches_jax(alpha, intercept, K):
    # expectation-value scale: |y| ≲ 1, where f32 rounds at ~1e-7
    rng = np.random.default_rng(K)
    X = rng.uniform(-1, 1, size=(60, 5))
    y = X @ (0.2 * rng.normal(size=5)) + 0.3 if K == 0 else \
        X @ (0.2 * rng.normal(size=(5, K))) - 0.2
    y = y + 0.01 * rng.normal(size=y.shape)
    got = LinearRegression(alpha, intercept, device="cpu").fit(X, y)
    want = JLinear(alpha, intercept).fit(X, y)
    np.testing.assert_array_equal(got.coef_, want.coef_)
    np.testing.assert_array_equal(got.intercept_, want.intercept_)
    _close(got.predict(X), want.predict(X), 1e-6)
    moved = convert.linear_from_jax(want.coef_, want.intercept_, "cpu")
    _close(moved.predict(X), want.predict(X), 1e-6)


def _forest_data(kind):
    rng = np.random.default_rng(11)
    if kind == "tied":
        # discrete duplicated features: exact-SSE ties on every level
        step = np.repeat(np.arange(1, 5), 15).astype(np.float32)
        jv = np.tile(np.round(rng.uniform(0, 2, 15), 1), 4)
        noisy = np.cos(step * 0.4) * np.exp(-0.3 * jv)
        X = np.column_stack([step, jv, np.round(noisy, 2), step]
                            ).astype(np.float32)
        y = (np.cos(step * 0.4) * np.exp(-0.25 * jv)).astype(np.float32)
        return X, y
    X = rng.uniform(-1, 1, size=(80, 4)).astype(np.float32)
    y = np.stack([np.sin(2 * X[:, 0]), X[:, 1] * X[:, 2], -X[:, 3]], 1)
    return X, (y[:, 0] if kind == "single" else y).astype(np.float32)


@pytest.mark.parametrize("kind,kw", [
    ("single", {}), ("multi", {"max_features": 0.5}),
    ("tied", {"min_samples_leaf": 2}), ("single", {"max_depth": 3,
                                                   "bootstrap": False})])
def test_forest_matches_jax(kind, kw):
    """Same random_state: identical trees and predictions ≤ 1e-6; the JAX
    forest carried over predicts the same."""
    X, y = _forest_data(kind)
    got = RandomForestRegressor(12, random_state=5, device="cpu", **kw)
    want = jforest.RandomForestRegressor(12, random_state=5, **kw)
    got.fit(X, y)
    want.fit(X, y)
    for g, w in zip(got._stacked, want._stacked):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got._depth == want._depth
    Xq = np.concatenate([X, np.random.default_rng(1).uniform(
        X.min(), X.max(), size=(20, X.shape[1])).astype(np.float32)])
    _close(got.predict(Xq), want.predict(Xq), 1e-6)
    moved = convert.forest_from_jax([np.asarray(a) for a in want._stacked],
                                    want._depth, want._single_output, "cpu")
    _close(moved.predict(Xq), want.predict(Xq), 1e-6)


def test_forest_predict_before_fit():
    with pytest.raises(RuntimeError, match="fit"):
        RandomForestRegressor(device="cpu").predict(np.zeros((1, 2)))


# ---------------------------------------------------------------------------
# layers, init and the flax paths
# ---------------------------------------------------------------------------
def test_dense_init_is_flax_lecun_normal():
    layer = mlp.Dense(400, 300)
    mlp.init_params(layer, torch.Generator().manual_seed(0))
    w = layer.weight.detach().numpy()
    std = np.sqrt(1 / 400)
    assert abs(w.std() / std - 1) < 0.02
    assert np.abs(w).max() <= 2 * std / 0.87962566103423978 + 1e-7
    assert not layer.bias.detach().numpy().any()
    flax_w = np.asarray(fnn.Dense(300).init(jax.random.PRNGKey(0), jnp.ones(
        (1, 400)))["params"]["kernel"])
    assert abs(flax_w.std() / w.std() - 1) < 0.02
    a = mlp.init_params(mlp.Dense(5, 3), torch.Generator().manual_seed(3))
    b = mlp.init_params(mlp.Dense(5, 3), torch.Generator().manual_seed(3))
    assert torch.equal(a.weight, b.weight)


def _jax_model_and_port(name, hidden=15, K=1, F=22, obs=17):
    if name.startswith("MLP"):
        jm = getattr(jmlp, name)(hidden, K)
        return jm, getattr(mlp, name)(hidden, K, input_size=F)
    if name == "NgemEnsembleModel":
        return (jgnn.NgemEnsembleModel(hidden, K),
                gnn.NgemEnsembleModel(hidden, K, num_node_features=F,
                                      observable_size=obs))
    return (getattr(jgnn, name)(hidden, K),
            getattr(gnn, name)(hidden, K, num_node_features=F))


GNNS = ["ExpValCircuitGraphModel", "ExpValCircuitGraphModel2",
        "ExpValCircuitGraphModel3", "ExpValCircuitGraphModel4",
        "NgemEnsembleModel"]


def _init(jm, args):
    key = jax.random.PRNGKey(1)
    return jax.jit(lambda *a: jm.init({"params": key, "dropout": key}, *a,
                                      train=False))(*args)


def check_paths(variables, tm):
    """The paths of an actual flax ``init`` (tree_flatten_with_path) name
    every entry of the port's state_dict, with the transposed shapes."""
    paths = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]:
        keys = [p.key for p in path][1:]
        shape = tuple(leaf.shape)
        if keys[-1] == "kernel":
            keys[-1], shape = "weight", shape[::-1]
        paths[".".join(keys)] = shape
    assert paths == {k: tuple(v.shape) for k, v in tm.state_dict().items()}


@pytest.mark.parametrize("name,K", [("MLP1", 4), ("MLP2", 4), ("MLP3", 1)])
def test_mlp_forwards_match_jax(name, K, monkeypatch):
    rng = np.random.default_rng(2)
    X = rng.normal(size=(16, 58)).astype(np.float32)
    jm, tm = _jax_model_and_port(name, hidden=64, K=K, F=58)
    variables = _init(jm, (jnp.asarray(X[:1]),))
    check_paths(variables, tm)
    port_from_flax(tm, variables).eval()
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, X)
    _close(tm(torch.as_tensor(X)).detach(), want, TOL)

    no_dropout(monkeypatch, tm)
    tm.train()
    out, mutated = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, X)
    _close(tm(torch.as_tensor(X)).detach(), out, TOL)
    got = dict(tm.state_dict())
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            mutated.get("batch_stats", {}))[0]:
        _close(got[".".join(p.key for p in path)], leaf, STATS_TOL)


def test_batchnorm_running_stats_use_the_biased_variance():
    x = torch.as_tensor(np.random.default_rng(0).normal(
        1.0, 2.0, size=(8, 3)).astype(np.float32))
    bn = mlp.BatchNorm(3).train()
    bn(x)
    _close(bn.var, 0.99 + 0.01 * x.var(0, unbiased=False), STATS_TOL)
    _close(bn.mean, 0.01 * x.mean(0), STATS_TOL)


@pytest.mark.parametrize("name", GNNS)
def test_gnn_forwards_match_jax(name, monkeypatch):
    """The flax paths name the port's state_dict; eval forward from
    converted weights at hidden 15 (heads 5/3 for v3 and v4), padded
    nodes, duplicate edges; then a train-mode forward with dropout off
    (BatchNorm on batch statistics)."""
    d = graph_batch(K=1)
    jm, tm = _jax_model_and_port(name)
    args = jax_args(d)
    variables = _init(jm, args)
    check_paths(variables, tm)
    port_from_flax(tm, variables).eval()
    want = jax.jit(lambda v, *a: jm.apply(v, *a, train=False))(
        variables, *args)
    _close(tm(*torch_args(d)).detach(), want, TOL)

    no_dropout(monkeypatch, tm)
    tm.train()
    out, mutated = jax.jit(lambda v, *a: jm.apply(
        v, *a, train=True, mutable=["batch_stats"]))(variables, *args)
    _close(tm(*torch_args(d)).detach(), out, TOL)
    got = dict(tm.state_dict())
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            mutated.get("batch_stats", {}))[0]:
        _close(got[".".join(p.key for p in path)], leaf, STATS_TOL)


def test_edge_index_to_adj_reduces_duplicates_by_max():
    d = graph_batch(B=4, N=7)
    d["edge_index"][:, :, -1] = d["edge_index"][:, :, 0:1][:, :, 0]
    d["edge_mask"][:, -1] = False          # a masked duplicate adds nothing
    want = jgnn.edge_index_to_adj(jnp.asarray(d["edge_index"]),
                                  jnp.asarray(d["edge_mask"]), 7)
    got = gnn.edge_index_to_adj(torch.as_tensor(d["edge_index"]),
                                torch.as_tensor(d["edge_mask"]), 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_asa_pooling_matches_jax_with_tied_scores():
    """Identical nodes give tied fitness scores: the stable sort keeps the
    JAX order, so the kept prefix, its mask and its coarsened adjacency
    agree."""
    rng = np.random.default_rng(3)
    B, N, C = 4, 11, 6
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    x[:, 5:9] = x[:, 4:5]                   # four copies of node 4
    adj = (rng.random((B, N, N)) < 0.3).astype(np.float32)
    adj[:, :, 5:9] = 0.0
    adj[:, 5:9, :] = 0.0
    mask = np.ones((B, N), bool)
    mask[1, 8:] = False
    mask[3, 5:] = False
    jm = jgnn.ASAPoolingDense(C, ratio=0.5)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(adj),
                jnp.asarray(mask))
    want = jax.jit(jm.apply)(v, x, adj, mask)
    tm = gnn.ASAPoolingDense(C, ratio=0.5)
    tm.load_state_dict(convert.state_dict_from_flax(
        jax.tree.map(np.asarray, v)))
    got = tm(*map(torch.as_tensor, (x, adj, mask)))
    n_keep = int(np.ceil(0.5 * N))
    for g, w in zip(got, want):
        assert g.shape[1] == n_keep
    _close(got[0].detach(), want[0], TOL)
    np.testing.assert_array_equal(got[1].detach().numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for b in range(B):
        kc = int(np.ceil(0.5 * mask[b].sum()))
        assert got[2][b, :kc].all() and not got[2][b, kc:].any()
