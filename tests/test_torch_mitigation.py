"""Port vs JAX package: the transpiler, Circuit.inverse, gate folding,
Pauli twirling and digital ZNE.

Circuits cross as ``to_dict()``: host transforms with the same seed give
the same op lists; unitaries are compared as dense matrices; ZNE through
``NoisyEstimator(shots=None)`` is held to 1e-5 of JAX's.
"""
import numpy as np
import pytest

from mlqem_tpu.circuits.circuit import Circuit as JCircuit
from mlqem_tpu.circuits.families import IsingModel as JIsing
from mlqem_tpu.circuits.families import IsingOptions as JIsingOptions
from mlqem_tpu.circuits.observables import single_z as j_single_z
from mlqem_tpu.device.registry import get_device as j_get_device
from mlqem_tpu.mitigation import twirling as jtw
from mlqem_tpu.mitigation import zne as jz
from mlqem_tpu.primitives.estimator import IdealEstimator as JIdeal
from mlqem_tpu.primitives.estimator import NoisyEstimator as JNoisy
from mlqem_tpu.transpile import lower as jl

from mlqem_tpu_torch import (Circuit, IdealEstimator, NoisyEstimator,
                             ZNEEstimator, ZNEStrategy, get_device,
                             sample_twirled_circuits, tensorize,
                             twirl_circuit, zne)
from mlqem_tpu_torch.circuits.gates import gate_unitary
from mlqem_tpu_torch.circuits.observables import single_z
from mlqem_tpu_torch.mitigation import twirling as tw
from mlqem_tpu_torch.mitigation import zne as tz
from mlqem_tpu_torch.ops.statevector import statevector
from mlqem_tpu_torch.transpile import lower as tl

from port_fixtures import one_torch_thread  # noqa: F401


def _jax_circuit(cu3=True):
    c = (JCircuit(3).h(0).cx(0, 1).cz(1, 2).rx(0.3, 2).ecr(2, 0)
         .rzz(0.5, 0, 1).cp(0.4, 1, 2).u3(0.3, 0.2, 0.1, 0).sdg(1)
         .swap(0, 2).t(2).ry(-0.6, 1).ch(0, 1).crz(0.7, 2, 0)
         .rxx(0.2, 0, 2).ryy(0.3, 1, 2).cy(1, 0).sxdg(2).u2(0.1, 0.5, 1))
    if cu3:
        c.cu3(0.4, 0.3, 0.2, 2, 1)
    return c.p(0.9, 0).barrier().measure_all()


def _unitary(c):
    """Dense unitary of a port circuit (qubit 0 = LSB), from the gates'
    own matrices."""
    n = c.num_qubits
    u = np.eye(2 ** n, dtype=np.complex128)
    for op in c.ops:
        if op.name in ("barrier", "measure"):
            continue
        g = gate_unitary(op.name, op.params)
        full = np.zeros_like(u)
        qs = op.qubits
        for col in range(2 ** n):
            bits = [(col >> q) & 1 for q in qs]
            local = int("".join(map(str, bits)), 2)   # first operand = MSB
            for loc_out in range(2 ** len(qs)):
                amp = g[loc_out, local]
                if amp == 0:
                    continue
                row = col
                for k, q in enumerate(qs):
                    bit = (loc_out >> (len(qs) - 1 - k)) & 1
                    row = (row & ~(1 << q)) | (bit << q)
                full[row, col] += amp
        u = full @ u
    return u


def _equal_up_to_phase(a, b, tol=1e-9):
    k = np.unravel_index(np.argmax(np.abs(b)), b.shape)
    phase = a[k] / b[k]
    return abs(abs(phase) - 1) < tol and np.allclose(a, phase * b,
                                                     atol=tol)


def test_inverse_matches_jax_and_undoes_the_circuit():
    jc = _jax_circuit()
    c = Circuit.from_dict(jc.to_dict())
    assert c.inverse().to_dict() == jc.inverse().to_dict()
    body = Circuit.from_dict(jc.to_dict())
    u = _unitary(body)
    np.testing.assert_allclose(_unitary(body.inverse()) @ u,
                               np.eye(u.shape[0]), atol=1e-9)
    for op in c.ops:
        if op.name not in ("barrier", "measure"):
            got = tl.invert_op(op)
            want = jl.invert_op(jl.Op(op.name, op.qubits, op.params))
            assert (got.name, got.qubits, got.params) == (
                want.name, want.qubits, want.params)


@pytest.mark.parametrize("basis", [("cx", "id", "rz", "sx", "x"),
                                   ("ecr", "id", "rz", "sx", "x")])
def test_transpile_matches_jax(basis):
    """The lowered op lists equal JAX's; they keep the circuit's unitary
    (up to phase) for every gate but cu3, whose lowering in the JAX
    package, and so in the port, does not."""
    jc = _jax_circuit()
    c = Circuit.from_dict(jc.to_dict())
    got = tl.transpile(c, basis=basis)
    want = jl.transpile(jc, basis=basis)
    assert got.to_dict() == want.to_dict()
    assert {op.name for op in got.ops} <= set(basis) | {"barrier", "measure"}
    plain = Circuit.from_dict(_jax_circuit(cu3=False).to_dict())
    assert _equal_up_to_phase(_unitary(tl.transpile(plain, basis=basis)),
                              _unitary(plain), tol=1e-7)
    routed = tl.transpile(c, coupling_map=[(0, 1), (1, 2)], num_qubits=3)
    assert routed.to_dict() == jl.transpile(
        jc, coupling_map=[(0, 1), (1, 2)], num_qubits=3).to_dict()
    assert tl.zxz_angles(gate_unitary("h")) == jl.zxz_angles(
        gate_unitary("h"))


@pytest.mark.parametrize("nf,gates", [(1.0, 2), (3.0, 2), (2.0, 2),
                                      (5.0, None), (2.5, 1)])
def test_fold_gates_matches_jax(nf, gates):
    jc = _jax_circuit()
    c = Circuit.from_dict(jc.to_dict())
    got = tz.fold_gates(c, nf, gates_to_fold=gates, seed=3)
    assert got.to_dict() == jz.fold_gates(jc, nf, gates, seed=3).to_dict()
    assert _equal_up_to_phase(_unitary(got), _unitary(c), tol=1e-7)
    assert tz.fold_global(c, nf).to_dict() == jz.fold_global(
        jc, nf).to_dict()


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_twirling_matches_jax(seed):
    jc = JCircuit(3).h(0).cx(0, 1).cz(1, 2).rx(0.4, 0).cx(1, 2).ecr(0, 2)
    c = Circuit.from_dict(jc.to_dict())
    got = twirl_circuit(c, seed=seed)
    assert got.to_dict() == jtw.twirl_circuit(jc, seed=seed).to_dict()
    psi0 = statevector(tensorize(c), device="cpu").numpy()
    psi1 = statevector(tensorize(got), device="cpu").numpy()
    assert abs(abs(np.vdot(psi0, psi1)) - 1.0) < 1e-5
    for balanced in (True, False):
        a = sample_twirled_circuits(c, 5, seed=seed, balanced=balanced)
        b = jtw.sample_twirled_circuits(jc, 5, seed=seed, balanced=balanced)
        assert [x.to_dict() for x in a] == [x.to_dict() for x in b]
    for gate in ("cx", "cz", "ecr", "swap"):
        assert tw.twirl_table(gate) == jtw.twirl_table(gate)
    with pytest.raises(ValueError):
        tw.twirl_table("rzz")
    v = np.arange(12.0)
    np.testing.assert_array_equal(tw.twirl_average(v, 3),
                                  jtw.twirl_average(v, 3))


def test_extrapolators_match_jax():
    nfs = [1, 3, 5]
    vals = [0.81, 0.62, 0.47]
    for name in ("linear", "polynomial", "richardson", "exponential"):
        got = ZNEStrategy(extrapolator=name).extrapolator.extrapolate(
            nfs, vals)
        want = jz.ZNEStrategy(extrapolator=name).extrapolator.extrapolate(
            nfs, vals)
        assert got == pytest.approx(want, abs=1e-12)
    with pytest.raises(ValueError, match="extrapolator"):
        ZNEStrategy(extrapolator="cubic")


@pytest.mark.parametrize("folding,twirls", [("local", 0), ("global", 0),
                                            ("local", 2)])
def test_zne_matches_jax(folding, twirls):
    """ZNE(NoisyEstimator, shots=None) within 1e-5 of JAX's, and closer to
    the ideal value than the unmitigated one."""
    ops = JIsingOptions.config_4q_paper()
    jcs = [JIsing.make_circs_sweep(ops, s, "Z", measure=False)
           for s in (1, 2)]
    cs = [Circuit.from_dict(c.to_dict()) for c in jcs]
    strat = dict(noise_factors=(1, 3, 5), folding=folding,
                 num_twirls=twirls, extrapolator="polynomial")
    jdev, dev = j_get_device("fake_lima"), get_device("fake_lima")
    want = jz.ZNEEstimator(JNoisy(jdev, readout=False),
                           jz.ZNEStrategy(**strat)).run(
        jcs, j_single_z(0, 4)).result()
    got = ZNEEstimator(NoisyEstimator(dev, readout=False, device="cpu"),
                       ZNEStrategy(**strat)).run(cs, single_z(0, 4)).result()
    np.testing.assert_allclose(got.values, want.values, atol=1e-5)
    np.testing.assert_allclose(got.metadata[0]["zne"]["measured"],
                               want.metadata[0]["zne"]["measured"],
                               atol=1e-5)
    ideal = IdealEstimator(device="cpu").run(cs, single_z(0, 4)
                                             ).result().values
    noisy = NoisyEstimator(dev, readout=False, device="cpu").run(
        cs, single_z(0, 4)).result().values
    assert np.abs(got.values - ideal).mean() < np.abs(noisy - ideal).mean()


def test_zne_class_decorator():
    ZNENoisy = zne(NoisyEstimator)
    assert ZNENoisy.__name__ == "ZNENoisyEstimator"
    est = ZNENoisy(get_device("fake_lima"), device="cpu",
                   zne_strategy=ZNEStrategy(noise_factors=(1, 3)))
    res = est.run(Circuit(2).h(0).cx(0, 1), "ZZ").result()
    assert res.values.shape == (1,)
    assert res.metadata[0]["zne"]["noise_factors"] == [1, 3]
    jres = jz.zne(JNoisy)(j_get_device("fake_lima"),
                          zne_strategy=jz.ZNEStrategy(
                              noise_factors=(1, 3))).run(
        JCircuit(2).h(0).cx(0, 1), "ZZ").result()
    np.testing.assert_allclose(res.values, jres.values, atol=1e-5)
