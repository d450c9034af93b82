"""Port vs JAX package: encoders, graph encodings, dataset generators and
loaders, metrics.

The host encoders, graph dicts and padded arrays must be equal exactly;
generated labels (``NoisyEstimator(shots=None)``, the ideal statevector)
within 1e-5 of JAX's; circuits and observables of a seed equal.
"""
import json

import numpy as np
import pytest

from mlqem_tpu.circuits.circuit import Circuit as JCircuit
from mlqem_tpu.circuits.families import random_circuit as j_random_circuit
from mlqem_tpu.data import encoders as je
from mlqem_tpu.data import generators as jgen
from mlqem_tpu.data import graph as jg
from mlqem_tpu.data import loaders as jl
from mlqem_tpu.device.registry import get_device as j_get_device
from mlqem_tpu import metrics as jm
from mlqem_tpu.transpile.lower import transpile as j_transpile

from mlqem_tpu_torch import Circuit, get_device, metrics
from mlqem_tpu_torch.data import encoders as te
from mlqem_tpu_torch.data import generators as tgen
from mlqem_tpu_torch.data import graph as tg
from mlqem_tpu_torch.data import loaders as tl
from mlqem_tpu_torch.exceptions import MLQEMException

from port_fixtures import one_torch_thread  # noqa: F401

LABEL_TOL = 1e-5


def _circuit_pairs(n=5, nq=4):
    """Transpiled random circuits (and an empty one), JAX and port."""
    dev = j_get_device("fake_lima")
    jcs = [j_transpile(j_random_circuit(nq, 1 + s % 3, seed=s),
                       basis=dev.basis_gates) for s in range(n)]
    jcs.append(JCircuit(nq))
    return jcs, [Circuit.from_dict(c.to_dict()) for c in jcs]


def test_encoders_match_jax_exactly():
    jcs, cs = _circuit_pairs()
    props = get_device("fake_lima").properties()
    jprops = j_get_device("fake_lima").properties()
    assert props == jprops
    rng = np.random.default_rng(0)
    noisy = rng.uniform(-1, 1, size=(len(cs), 4)).tolist()
    ideal = rng.uniform(-1, 1, size=(len(cs), 4)).tolist()
    bases = [te.encode_pauli_sum_op("XZIY")[0] for _ in cs]
    for args, kw in (((ideal, noisy, 4), {}),
                     ((ideal, noisy, 4), {"meas_bases": bases})):
        got = te.encode_data(cs, props, *args, **kw)
        want = je.encode_data(jcs, jprops, *args, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert got[0].shape[1] == 58 + 17
    assert te.encode_data(cs, props, ideal, noisy, 4)[0].shape[1] == 58
    got = te.encode_data_v2_ecr(cs, ideal, noisy, 4, meas_bases=bases)
    want = je.encode_data_v2_ecr(jcs, ideal, noisy, 4, meas_bases=bases)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(te.device_stat_vector(props),
                                  je.device_stat_vector(jprops))
    assert te.encode_pauli_sum_op("XYZI") == je.encode_pauli_sum_op("XYZI")
    # the reference quirks: 'x' matches cx and sx too; qubit 0 is dropped
    assert te.recursive_dict_loop(props, out=[], target_key1="x",
                                  target_key2="gate_error") == \
        je.recursive_dict_loop(jprops, out=[], target_key1="x",
                               target_key2="gate_error")
    assert "reset" in props["gates_set"]


def test_count_estimators_match_jax():
    counts = {"000": 10, "101": 30, "011": 5, "110": 55}
    np.testing.assert_array_equal(te.cal_z_exp(counts), je.cal_z_exp(counts))
    np.testing.assert_allclose(te.cal_z_exp({"1": 3, "0": 1}), [0.5])
    assert te.cal_all_z_exp(counts, [0, 2]) == je.cal_all_z_exp(counts,
                                                                 [0, 2])
    assert te.marginal_counts(counts, [1]) == je.marginal_counts(counts, [1])
    assert te.counts_to_feature_vector(counts, 3) == \
        je.counts_to_feature_vector(counts, 3)
    z = np.random.default_rng(1).uniform(-1, 1, size=(6, 4))
    np.testing.assert_array_equal(te.calc_imbalance(z, [0, 2], [1, 3]),
                                  je.calc_imbalance(z, [0, 2], [1, 3]))


def test_graphs_match_jax_exactly():
    jcs, cs = _circuit_pairs()
    props = get_device("fake_lima").properties()
    jprops = j_get_device("fake_lima").properties()
    graphs = []
    for jc, c in zip(jcs, cs):
        for gate, qubit in ((False, False), (True, True), (True, False)):
            got = tg.circuit_to_graph_data_json(c, props, gate, qubit)
            assert got == jg.circuit_to_graph_data_json(jc, jprops, gate,
                                                        qubit)
        graphs.append(got)
        hom, jhom = (tg.circuit_to_homogeneous_graph(c),
                     jg.circuit_to_homogeneous_graph(jc))
        assert hom.keys() == jhom.keys()
        for k in hom:
            np.testing.assert_array_equal(hom[k], jhom[k])
    full = [tg.circuit_to_graph_data_json(c, props, True, True) for c in cs]
    assert len(full[0]["nodes"]["DAGOpNode"][0]) == \
        tg.num_node_features(props) == 22
    for g_in in (full, graphs):
        got, want = tg.stack_graphs(g_in), jg.stack_graphs(g_in)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="too large"):
        tg.graph_to_arrays(full[0], 1, 1)


@pytest.fixture(scope="module")
def datasets():
    """generate_exp_val_dataset(fake_lima, 3, 2, num_entries=8), both."""
    kw = dict(num_entries=8, seed=4)
    return (tgen.generate_exp_val_dataset(get_device("fake_lima"), 3, 2,
                                          device="cpu", **kw),
            jgen.generate_exp_val_dataset(j_get_device("fake_lima"), 3, 2,
                                          **kw))


def test_generated_dataset_matches_jax(datasets):
    got, want = datasets
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.circuit == w.circuit
        assert g.circuit_graph == w.circuit_graph
        assert g.observable == w.observable
        assert g.circuit_depth == w.circuit_depth
        assert abs(g.ideal_exp_value - w.ideal_exp_value) <= LABEL_TOL
        np.testing.assert_allclose(g.noisy_exp_values, w.noisy_exp_values,
                                   atol=LABEL_TOL, rtol=0)
    assert any(abs(e.ideal_exp_value) > 0.1 for e in got)


def test_dataset_arrays_match_jax(datasets, tmp_path):
    """ExpValDataset arrays (self-loops on and off) and batches are equal;
    a JAX-saved .json and .pk load; .npz arrays round-trip."""
    got, want = datasets
    for loops in (True, False):
        a = tl.ExpValDataset(got, add_self_loops=loops)
        b = jl.ExpValDataset(want, add_self_loops=loops)
        assert (a.max_nodes, a.max_edges) == (b.max_nodes, b.max_edges)
        for k in b.arrays:
            if k in ("y", "noisy"):
                np.testing.assert_allclose(a.arrays[k], b.arrays[k],
                                           atol=LABEL_TOL, rtol=0)
            else:
                np.testing.assert_array_equal(a.arrays[k], b.arrays[k])
    for x, y in zip(a.batches(3, seed=2), b.batches(3, seed=2)):
        np.testing.assert_array_equal(x["x"], y["x"])
    path = str(tmp_path / "entries.json")
    jl.save_entries_json(want, path)
    loaded = tl.load_entries(path)
    assert [e.to_dict() for e in loaded] == [e.to_dict() for e in want]
    with open(path) as f:
        assert json.load(f)[0]["circuit_depth"] == want[0].circuit_depth
    from_path = tl.ExpValDataset(path)
    np.testing.assert_array_equal(from_path.arrays["x"],
                                  jl.ExpValDataset(path).arrays["x"])
    import pickle
    pk = str(tmp_path / "entries.pk")
    with open(pk, "wb") as f:
        pickle.dump([{**e.to_dict(), "circuit": e.circuit} for e in want], f)
    assert [e.circuit for e in tl.load_entries(pk)] == [None] * 8
    npz = str(tmp_path / "arrays.npz")
    tl.save_arrays_npz(a.arrays, npz)
    back = jl.load_arrays_npz(npz)
    for k in a.arrays:
        np.testing.assert_array_equal(back[k], a.arrays[k])
    with pytest.raises(ValueError, match="no entries"):
        tl.ExpValDataset([])


def test_exp_value_generator_batches_by_seed():
    dev = get_device("fake_lima")
    stream = list(tgen.exp_value_generator(dev, 3, 2, 1, max_entries=5,
                                           batch_size=3, device="cpu"))
    want = (tgen.generate_exp_val_dataset(dev, 3, 2, 1, num_entries=3,
                                          seed=0, device="cpu")
            + tgen.generate_exp_val_dataset(dev, 3, 2, 1, num_entries=2,
                                            seed=1, device="cpu"))
    assert [e.to_dict() for e in stream] == [e.to_dict() for e in want]
    assert "ExpValueEntry" in repr(stream[0])


def test_rb_matches_jax():
    """RB sequences equal JAX's at 1, 2 and 3 qubits (the multi-qubit ones
    inverted through ``ops/stabilizer.clifford_inverse_circuit``); the RB
    stream's labels ≤ 1e-5 of JAX's."""
    for nq, seed, length in ((1, 0, 1), (1, 3, 7), (1, 9, 20), (2, 0, 3),
                             (2, 5, 6), (3, 1, 4)):
        got = tgen.generate_rb_circuit(nq, length, seed=seed)
        assert got.to_dict() == jgen.generate_rb_circuit(
            nq, length, seed=seed).to_dict()
    got = list(tgen.rb_generator(get_device("fake_lima"), lengths=(4,),
                                 num_samples=3, seed=2, device="cpu"))
    want = list(jgen.rb_generator(j_get_device("fake_lima"), lengths=(4,),
                                  num_samples=3, seed=2))
    for (ge, gc, go), (we, wc, wo) in zip(got, want):
        assert gc.to_dict() == wc.to_dict()
        assert go.to_list() == wo.to_list()
        assert ge.circuit_graph == we.circuit_graph
        assert abs(ge.ideal_exp_value - we.ideal_exp_value) <= LABEL_TOL
        np.testing.assert_allclose(ge.noisy_exp_values, we.noisy_exp_values,
                                   atol=LABEL_TOL, rtol=0)


def test_metrics_match_jax():
    problems = [(0.5, [(0.4, 0.45), (0.3, 0.5)]), (-0.2, [(-0.1, -0.25)])]
    assert metrics.improvement_factor(problems, 100, 300) == \
        jm.improvement_factor(problems, 100, 300)
    golden = [metrics.Problem([metrics.Trial(0.0, 0.5)], 1.0)]
    assert metrics.improvement_factor(golden, 1, 1) == 2.0
    with pytest.raises(MLQEMException):
        metrics.improvement_factor([], 1, 1)
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, 5, 3))
    for name in ("rmse", "mae", "l2_distance_per_step"):
        np.testing.assert_array_equal(getattr(metrics, name)(a, b),
                                      getattr(jm, name)(a, b))
    np.testing.assert_array_equal(metrics.rmse(a, b, axis=0),
                                  jm.rmse(a, b, axis=0))
