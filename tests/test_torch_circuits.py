"""Port vs JAX package: the circuit IR, templates, families, observables.

These modules are host numpy in both packages, so their arrays are held
equal exactly; the port's template ``bind`` (a torch index-put) is held
equal to the JAX scatter as well.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlqem_tpu.circuits import circuit as jc
from mlqem_tpu.circuits import families as jf
from mlqem_tpu.circuits import observables as jo
from mlqem_tpu.circuits import parameters as jp
from mlqem_tpu.parallel.datagen import make_ising_template as j_template

from mlqem_tpu_torch.circuits import circuit as tc
from mlqem_tpu_torch.circuits import families as tf
from mlqem_tpu_torch.circuits import observables as to
from mlqem_tpu_torch.circuits import parameters as tp
from mlqem_tpu_torch.convert import (circuit_tensor_from_numpy,
                                     template_from_numpy)
from mlqem_tpu_torch.parallel.datagen import make_ising_template

from port_fixtures import one_torch_thread  # noqa: F401


def _assert_ct_equal(got, want):
    assert got.num_qubits == want.num_qubits
    for name in ("gate_ids", "qubits", "params"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        if torch.is_tensor(g):
            g = g.cpu().numpy()
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def _family_pairs():
    """(port circuit, JAX circuit) built by the same calls."""
    pairs = []
    for mod_c, mod_f in ((tc, tf), (jc, jf)):
        qc = mod_c.Circuit(3)
        qc.h(0).cx(0, 1).rz(0.3, 2).ry(-1.1, [0, 1]).swap(1, 2)
        qc.cp(0.7, 2, 0).u3(0.1, 0.2, 0.3, 1).rzz(0.4, 0, 2).measure_all()
        out = [qc,
               mod_f.IsingModel.make_circuit(
                   mod_f.IsingOptions.config_4q_paper(depth=2),
                   init=mod_f.ising_init_prefix_4q()),
               mod_f.IsingModel.make_circs_sweep(
                   mod_f.IsingOptions.config_6q_paper(), 2, "Y"),
               mod_f.construct_mbl_circuit(4, [0.1, 0.2, 0.3, 0.4], 0.5, 2),
               mod_f.construct_mbl_circuit(4, None, 0.5, 1,
                                           completely_random=True, seed=3),
               mod_f.construct_mbl_circ_with_cut(4, [0.1] * 4, 0.5, 2,
                                                 [(1, 2)]),
               mod_f.random_clifford_circuit(5, 4, seed=2),
               mod_f.random_circuit(4, 5, seed=9, measure=True),
               mod_f.construct_tiling(mod_f.random_circuit(2, 3, seed=1),
                                      5, offset=2),
               mod_f.generate_composed_clifford(3, 2, 2, seed=4),
               mod_c.Circuit(1).x(0).rx(0.2, 0)]
        pairs.append(out)
    return list(zip(*pairs))


@pytest.mark.parametrize("idx", range(11))
def test_circuits_and_tensorize_match_jax(idx):
    qc, jqc = _family_pairs()[idx]
    assert qc.to_dict() == jqc.to_dict()
    assert tc.Circuit.from_dict(jqc.to_dict()).to_dict() == jqc.to_dict()
    assert qc.count_ops() == jqc.count_ops()
    assert qc.depth() == jqc.depth()
    assert qc.num_nonstructural_ops() == jqc.num_nonstructural_ops()
    np.testing.assert_array_equal(qc.rotation_angles(),
                                  jqc.rotation_angles())
    assert qc.draw() == jqc.draw() and repr(qc) == repr(jqc)
    _assert_ct_equal(tc.tensorize(qc), jc.tensorize(jqc))
    L = tc.pad_pow2_bucket(qc.num_nonstructural_ops())
    assert L == jc.pad_pow2_bucket(jqc.num_nonstructural_ops())
    _assert_ct_equal(tc.tensorize(qc, L), jc.tensorize(jqc, L))


def test_stack_circuits_match_jax():
    pairs = [p for p in _family_pairs() if p[0].num_qubits == 4]
    assert len(pairs) >= 4
    got = tc.stack_circuits([p[0] for p in pairs])
    want = jc.stack_circuits([p[1] for p in pairs])
    _assert_ct_equal(got, want)
    _assert_ct_equal(
        circuit_tensor_from_numpy(want.gate_ids, want.qubits, want.params,
                                  want.num_qubits), want)
    with pytest.raises(ValueError, match="equal width"):
        tc.stack_circuits([pairs[0][0], tc.Circuit(2)])


def test_circuit_validation():
    with pytest.raises(ValueError, match="unknown gate"):
        tc.Op("bogus", (0,))
    with pytest.raises(ValueError, match="out of range"):
        tc.Circuit(2).h(2)
    with pytest.raises(ValueError, match="expects 2 qubits"):
        tc.Circuit(2).append("cx", (0,))
    with pytest.raises(ValueError, match="max_ops"):
        tc.tensorize(tc.Circuit(2).h(0).h(1), max_ops=1)


def _ansatz_pair():
    return (tf.two_local_ansatz(3, reps=2, entanglement="linear"),
            jf.two_local_ansatz(3, reps=2, entanglement="linear"))


@pytest.mark.parametrize("which", ["ising", "ising_symbolic_h", "ansatz"])
def test_templates_and_bind_match_jax(which, rng):
    if which == "ansatz":
        qc, jqc = _ansatz_pair()
        tpl, jtpl = tp.tensorize_template(qc), jp.tensorize_template(jqc)
    else:
        h = 1.0 if which == "ising" else None
        tpl = make_ising_template(4, 2, "Z", 0.25, h=h)
        jtpl = j_template(4, 2, "Z", 0.25, h=h)
    names = [p.name for p in tpl.parameters]
    assert names == [p.name for p in jtpl.parameters]
    for name in ("slot_op", "slot_par", "slot_param", "slot_coeff"):
        g, w = getattr(tpl, name), getattr(jtpl, name)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w, err_msg=name)
    _assert_ct_equal(tpl.ct, jtpl.ct)
    values = rng.uniform(-2, 2, size=(5, tpl.num_parameters)
                         ).astype(np.float32)
    _assert_ct_equal(tpl.bind_host(values[0]), jtpl.bind_host(values[0]))
    bound = tpl.bind(torch.as_tensor(values))
    assert torch.is_tensor(bound.params)
    assert bound.params.dtype == torch.float32
    _assert_ct_equal(bound, jtpl.bind(jnp.asarray(values)))
    # a template carried across from the JAX side binds the same way
    carried = template_from_numpy(
        jtpl.ct.gate_ids, jtpl.ct.qubits, jtpl.ct.params,
        jtpl.ct.num_qubits, jtpl.slot_op, jtpl.slot_par, jtpl.slot_param,
        jtpl.slot_coeff, names)
    _assert_ct_equal(carried.bind(torch.as_tensor(values)), bound)


def test_bind_parameters_and_expressions():
    t = tp.Parameter("t")
    qc = tc.Circuit(2).rx(t, 0).rz(-2.0 * t, 1).ry(0.5, 0)
    jt = jp.Parameter("t")
    jqc = jc.Circuit(2).rx(jt, 0).rz(-2.0 * jt, 1).ry(0.5, 0)
    for values in ([0.3], {"t": 0.3}):
        got = tp.bind_parameters(qc, values).to_dict()
        assert got == jp.bind_parameters(jqc, values).to_dict()
    assert (-t).coeff == -1.0 and (3 * t).coeff == 3.0
    u = tp.Parameter("u")
    qc2 = tc.Circuit(2).rx(u, 0).rz(2.0 * t, 1).ry(u, 1)
    assert [p.name for p in tp.circuit_parameters(qc2)] == ["u", "t"]


@pytest.mark.parametrize("preset", ["config_4q_paper", "config_6q_paper",
                                    "config_10q_paper",
                                    "config_100q_paper_clifford",
                                    "config_100q_paper_nonclifford"])
def test_ising_presets_match_jax(preset):
    got = getattr(tf.IsingOptions, preset)(depth=3)
    want = getattr(jf.IsingOptions, preset)(depth=3)
    assert vars(got) == vars(want)


def test_observables_match_jax():
    for build in (lambda m: m.PauliSum([("XYZI", 0.5), ("ZZII", -1.0)]),
                  lambda m: m.PauliSum("IXYZ"),
                  lambda m: m.single_z(1, 4, 2.0),
                  lambda m: m.all_z(4),
                  lambda m: m.random_pauli_sum(4, 6, seed=3)):
        got, want = build(to), build(jo)
        assert got.to_list() == want.to_list()
        for g, w in zip(got.masks(), want.masks()):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got.code_matrix(), want.code_matrix())
        np.testing.assert_array_equal(got.coeffs(), want.coeffs())
        np.testing.assert_allclose(got.to_matrix(), want.to_matrix(),
                                   atol=1e-12)
        assert got.is_diagonal() == want.is_diagonal()
    with pytest.raises(ValueError, match="bad Pauli"):
        to.PauliSum("XQ")
