"""Port vs JAX package: the Estimator primitives.

The same circuits are built in both packages (the port's from the JAX
one's ``to_dict``). Exact paths (``shots=None``) are held to 1e-5; sampled
ones within 5 standard errors of the exact value; the trajectory
estimator to 1e-5 on draws shared with JAX.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlqem_tpu.ops.sampling as j_sampling
from mlqem_tpu.circuits.circuit import Circuit as JCircuit
from mlqem_tpu.circuits.families import IsingModel as JIsing
from mlqem_tpu.circuits.families import IsingOptions as JIsingOptions
from mlqem_tpu.circuits.observables import PauliSum as JPauliSum
from mlqem_tpu.circuits.parameters import Parameter as JParameter
from mlqem_tpu.device.registry import get_device as j_get_device
from mlqem_tpu.primitives import estimator as je
from mlqem_tpu.primitives.trajectory_estimator import \
    TrajectoryEstimator as JTrajectoryEstimator

import mlqem_tpu_torch.ops.sampling as t_sampling
from mlqem_tpu_torch import (Circuit, CountsBackend, IdealEstimator,
                             NoisyEstimator, PauliSum, TrajectoryEstimator,
                             get_device)
from mlqem_tpu_torch.circuits.parameters import Parameter
from mlqem_tpu_torch.primitives.estimator import (_measurement_groups,
                                                  _normalize_run_args)

from port_fixtures import one_torch_thread  # noqa: F401

HAM = [("II", -1.05), ("ZI", 0.39), ("IZ", -0.39), ("ZZ", -0.01),
       ("XX", 0.18), ("YY", 0.18), ("XI", 0.3), ("IY", -0.2)]


def _circuits():
    """Bell-like and rotated 3-qubit circuits, in both packages."""
    jcs = [JCircuit(3).h(0).cx(0, 1).rx(0.3, 1),
           JCircuit(3).ry(0.7, 0).cx(1, 0).rz(0.2, 0).sx(1).cx(2, 1),
           JCircuit(3).h(0).cx(0, 1).cx(1, 2).ry(0.4, 2).measure_all()]
    return jcs, [Circuit.from_dict(c.to_dict()) for c in jcs]


def _obs(n):
    terms = [(("I" * (n - 2)) + p, c) for p, c in HAM]
    return JPauliSum(terms), PauliSum(terms)


@pytest.fixture(scope="module")
def lima():
    return j_get_device("fake_lima"), get_device("fake_lima")


def test_ideal_estimator_matches_jax():
    jcs, cs = _circuits()
    jobs, obs = zip(*(_obs(c.num_qubits) for c in cs))
    want = je.IdealEstimator().run(jcs, list(jobs)).result().values
    for k, (c, o) in enumerate(zip(cs, obs)):
        res = IdealEstimator(device="cpu").run(c, o).result()
        np.testing.assert_allclose(res.values, want[k:k + 1], atol=1e-5)
        assert res.metadata[0]["simulator"] == "statevector"
    bell = Circuit(2).h(0).cx(0, 1)
    vals = IdealEstimator(device="cpu").run(
        [bell, bell], [PauliSum("ZZ"), PauliSum("YY")]).result().values
    np.testing.assert_allclose(vals, [1.0, -1.0], atol=1e-6)


def test_parameterized_run_matches_jax():
    jt, t = JParameter("t"), Parameter("t")
    jqc = JCircuit(2).rx(jt, 0).rz(jt * 2.0, 1).cx(0, 1)
    qc = Circuit(2).rx(t, 0).rz(t * 2.0, 1).cx(0, 1)
    pv = [(0.5,), (1.5,)]
    want = je.IdealEstimator().run([jqc, jqc], JPauliSum("YZ"),
                                   parameter_values=pv).result().values
    got = IdealEstimator(device="cpu").run([qc, qc], PauliSum("YZ"),
                                           parameter_values=pv).result()
    np.testing.assert_allclose(got.values, want, atol=1e-5)
    with pytest.raises(ValueError, match="length mismatch"):
        _normalize_run_args([qc, qc], [PauliSum("ZZ")] * 3, None)
    with pytest.raises(ValueError, match="width"):
        _normalize_run_args([qc], PauliSum("ZZZ"), None)


@pytest.mark.parametrize("readout", [True, False])
def test_noisy_estimator_matches_jax(readout, lima):
    """shots=None: the diagonal terms from the dm diagonal (readout off)
    or every group through its noisy rotation and readout (readout on)."""
    jcs, cs = _circuits()
    jobs, obs = zip(*(_obs(c.num_qubits) for c in cs))
    want = je.NoisyEstimator(lima[0], readout=readout).run(
        jcs, list(jobs)).result().values
    res = NoisyEstimator(lima[1], readout=readout, device="cpu").run(
        cs, list(obs)).result()
    np.testing.assert_allclose(res.values, want, atol=1e-5)
    assert res.metadata[0] == {"simulator": "density_matrix", "shots": None,
                               "readout": readout}
    ideal = IdealEstimator(device="cpu").run(cs, list(obs)).result().values
    assert np.abs(res.values - ideal).max() > 1e-3


def test_measurement_groups_match_jax():
    jo, o = _obs(3)
    want = je._measurement_groups(jo.terms)
    got = _measurement_groups(o.terms)
    assert [(b, [t.pauli for t in m]) for b, m in got] == \
        [(b, [t.pauli for t in m]) for b, m in want]


def test_noisy_estimator_shots_within_five_sigma(lima):
    """One shot table per basis group: the sampled value within 5σ of the
    exact one (σ ≤ Σ|c|/√S, the terms of a group sharing their shots)."""
    _, cs = _circuits()
    o = _obs(3)[1]
    S = 20000
    exact = NoisyEstimator(lima[1], device="cpu").run(
        cs[:2], o).result().values
    est = NoisyEstimator(lima[1], shots=S, seed=3, device="cpu")
    sampled = est.run(cs[:2], o).result().values
    bound = 5 * sum(abs(c) for p, c in HAM if p != "II") / np.sqrt(S)
    assert np.all(np.abs(sampled - exact) <= bound)
    again = est.run(cs[:2], o).result().values      # the generator moves on
    assert not np.array_equal(again, sampled)
    replay = NoisyEstimator(lima[1], shots=S, seed=3, device="cpu")
    np.testing.assert_array_equal(replay.run(cs[:2], o).result().values,
                                  sampled)


def test_counts_backend_matches_jax(lima):
    jqc = JCircuit(2).x(0).h(1).measure_all()
    qc = Circuit.from_dict(jqc.to_dict())
    want = je.CountsBackend(lima[0]).run_probs([jqc])
    backend = CountsBackend(lima[1], seed=1, device="cpu")
    probs = backend.run_probs([qc])
    np.testing.assert_allclose(probs, want, atol=1e-6)
    n = 8000
    counts = backend.run_counts([qc], shots=n)[0]
    assert sum(counts.values()) == n
    assert max(counts, key=counts.get) in ("01", "11")
    for j, p in enumerate(probs[0]):
        c = counts.get(format(j, "02b"), 0)
        assert abs(c - n * p) <= 5 * np.sqrt(n * p * (1 - p)) + 1e-9


def test_trajectory_estimator_matches_jax_on_shared_draws(monkeypatch,
                                                          lima):
    """Both estimators take the same (L, T) Pauli draws for every job; the
    JAX one traces its draws once per shape, the port's draws broadcast."""
    T = 7              # a shape no other test traces JAX's function with
    jqc = JIsing.make_circs_sweep(JIsingOptions.config_4q_paper(), 2, "Z",
                                  measure=False)
    qc = Circuit.from_dict(jqc.to_dict())
    terms = [("IIIZ", 1.0), ("IXXI", 0.5), ("YIIZ", -0.3)]
    # wide enough for any job's ops; each side takes the first L columns
    draws = np.random.default_rng(4).integers(0, 16, size=(T, 256)).astype(
        np.int32)
    draws[np.random.default_rng(5).random(draws.shape) < 0.6] = 0

    def j_draws(key, probs, shape):                 # shape (L, T)
        return jnp.asarray(draws[:, :shape[0]].T)

    def t_draws(probs, shape, gen):
        return torch.as_tensor(np.broadcast_to(draws[:, :shape[-1]],
                                               shape).copy())

    monkeypatch.setattr(j_sampling, "sample_small_categorical", j_draws)
    monkeypatch.setattr(t_sampling, "sample_small_categorical", t_draws)
    want = JTrajectoryEstimator(lima[0], n_traj=T).run(
        jqc, JPauliSum(terms)).result().values
    got = TrajectoryEstimator(lima[1], n_traj=T, device="cpu").run(
        qc, PauliSum(terms)).result()
    np.testing.assert_allclose(got.values, want, atol=1e-5)
    assert got.metadata[0]["simulator"] == "pauli_trajectory"


def test_trajectory_estimator_within_statistics_of_dm(lima):
    """Real draws: the trajectory mean within 5/√T plus the twirl's bias of
    the exact dm value; sampled shots stay in range."""
    qc = Circuit(3).h(0).cx(0, 1).cx(1, 2).rx(0.3, 1)
    o = PauliSum([("ZZI", 1.0), ("XXX", 0.5)])
    dm = NoisyEstimator(lima[1], device="cpu").run(qc, o).result().values[0]
    T = 2000
    tr = TrajectoryEstimator(lima[1], n_traj=T, seed=1, device="cpu").run(
        qc, o).result().values[0]
    assert abs(tr - dm) < 1.5 * 5 / np.sqrt(T) + 0.01
    sampled = TrajectoryEstimator(lima[1], n_traj=64, shots=6400, seed=2,
                                  device="cpu").run(qc, o).result().values[0]
    assert abs(sampled) <= 1.5
