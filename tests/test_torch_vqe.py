"""Port vs JAX package: the H2 problem set, VQE and SPSA.

The Estimators run with ``shots=None``, so both sides compute the same
deterministic energies (the port's on the CPU); the COBYLA paths are held
over their whole energy history. The VQE study's workflows are in
``test_torch_vqe_study.py``.
"""
import numpy as np
import pytest

from mlqem_tpu.apps.chemistry import load_h2_problems as j_load_h2
from mlqem_tpu.apps.vqe import VQE as JVQE
from mlqem_tpu.apps.vqe import spsa_minimize as j_spsa
from mlqem_tpu.circuits.families import two_local_ansatz as j_ansatz
from mlqem_tpu.device.registry import get_device as j_get_device
from mlqem_tpu.mitigation.learning import EmptyProcessor as JEmpty
from mlqem_tpu.mitigation.learning import learning as j_learning
from mlqem_tpu.primitives.estimator import IdealEstimator as JIdeal
from mlqem_tpu.primitives.estimator import NoisyEstimator as JNoisy

from mlqem_tpu_torch import (VQE, Circuit, EmptyProcessor, IdealEstimator,
                             NoisyEstimator, PauliSum,
                             exact_minimum_eigenvalue, get_device, learning,
                             load_h2_problems, spsa_minimize)
from mlqem_tpu_torch.circuits.families import two_local_ansatz
from mlqem_tpu_torch.circuits.parameters import circuit_parameters

from port_fixtures import one_torch_thread  # noqa: F401

DEV, J_DEV = get_device("fake_lima"), j_get_device("fake_lima")
TOL = 1e-5


def _estimators(kind):
    """(port, JAX) Estimators of one kind, ``shots=None``."""
    if kind == "ideal":
        return IdealEstimator(device="cpu"), JIdeal()
    return (NoisyEstimator(DEV, shots=None, device="cpu"),
            JNoisy(J_DEV, shots=None))


def test_h2_problems_match_jax():
    got, want = load_h2_problems(), j_load_h2()
    assert len(got) == len(want) >= 10
    for (length, fci, ham), (j_length, j_fci, j_ham) in zip(got, want):
        assert (length, fci) == (j_length, j_fci)
        assert [t.pauli for t in ham.terms] == ["II", "XX", "IZ", "ZZ", "ZI"]
        assert ham.to_list() == j_ham.to_list()
        np.testing.assert_array_equal(ham.to_matrix(), j_ham.to_matrix())
        assert abs(exact_minimum_eigenvalue(ham) - fci) < 0.02


@pytest.mark.parametrize("kind", ["ideal", "noisy"])
@pytest.mark.parametrize("separate", [False, True])
def test_energy_matches_jax(kind, separate):
    _, _, ham = load_h2_problems()[4]
    _, _, j_ham = j_load_h2()[4]
    est, j_est = _estimators(kind)
    vqe = VQE(est, two_local_ansatz(2, reps=3),
              separate_observables=separate)
    j_vqe = JVQE(j_est, j_ansatz(2, reps=3), separate_observables=separate)
    thetas = np.random.default_rng(1).uniform(-np.pi, np.pi, (8, 8))
    got = [vqe._energy(ham, th) for th in thetas]
    want = [j_vqe._energy(j_ham, th) for th in thetas]
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("kind", ["ideal", "noisy"])
def test_cobyla_history_matches_jax(kind):
    """COBYLA at 60 iterations from the same x0 on H2 (bond index 4): the
    whole energy history and the eigenvalue within 1e-5 of JAX's."""
    _, _, ham = load_h2_problems()[4]
    _, _, j_ham = j_load_h2()[4]
    est, j_est = _estimators(kind)
    res = VQE(est, two_local_ansatz(2, reps=3), maxiter=60,
              separate_observables=True, seed=0
              ).compute_minimum_eigenvalue(ham)
    j_res = JVQE(j_est, j_ansatz(2, reps=3), maxiter=60,
                 separate_observables=True, seed=0
                 ).compute_minimum_eigenvalue(j_ham)
    h, jh = np.array(res.energy_history), np.array(j_res.energy_history)
    assert len(h) == len(jh) == res.cost_function_evals == 60
    parted = np.flatnonzero(np.abs(h - jh) > TOL)
    assert parted.size == 0, (
        f"the histories part at evaluation {parted[0]}: {h[parted[0]]} vs "
        f"{jh[parted[0]]}")
    assert abs(res.eigenvalue - j_res.eigenvalue) <= TOL
    assert list(res.optimal_parameters) == [
        p.name for p in circuit_parameters(two_local_ansatz(2, reps=3))]


def test_spsa_iterates_identical_to_jax():
    calls, j_calls = [], []

    def quad(record):
        def f(x):
            record.append(np.array(x))
            return float(np.sum((x - 1.5) ** 2))
        return f

    res = spsa_minimize(quad(calls), np.zeros(3), maxiter=300, seed=0)
    j_res = j_spsa(quad(j_calls), np.zeros(3), maxiter=300, seed=0)
    assert len(calls) == len(j_calls) == res.nfev == 601
    np.testing.assert_array_equal(np.stack(calls), np.stack(j_calls))
    np.testing.assert_array_equal(res.x, j_res.x)
    assert res.fun == j_res.fun < 0.1


def test_vqe_runs_spsa_single_qubit_and_the_learning_estimator():
    """As the JAX package's tests: ry(θ) on H = Z reaches −1, SPSA runs
    through VQE, and VQE composes with the learning Estimator."""
    ansatz = two_local_ansatz(1, reps=1, entanglement="linear")
    res = VQE(IdealEstimator(device="cpu"), ansatz, maxiter=80, seed=1
              ).compute_minimum_eigenvalue(PauliSum("Z"))
    assert abs(res.eigenvalue + 1.0) < 1e-3
    spsa = VQE(IdealEstimator(device="cpu"), ansatz, optimizer="spsa",
               maxiter=40, seed=1).compute_minimum_eigenvalue(PauliSum("Z"))
    assert spsa.cost_function_evals == 81 and spsa.eigenvalue < -0.9
    est = learning(NoisyEstimator, EmptyProcessor(), skip_transpile=True)(
        DEV, device="cpu")
    j_est = j_learning(JNoisy, JEmpty(), skip_transpile=True)(J_DEV)
    a2 = two_local_ansatz(2, reps=1, entanglement="linear")
    got = VQE(est, a2, maxiter=30, separate_observables=True, seed=2
              ).compute_minimum_eigenvalue(PauliSum([("ZZ", 1.0)]))
    want = JVQE(j_est, j_ansatz(2, reps=1, entanglement="linear"),
                maxiter=30, separate_observables=True, seed=2
                ).compute_minimum_eigenvalue(PauliSum([("ZZ", 1.0)]))
    assert got.eigenvalue < -0.8
    np.testing.assert_allclose(got.energy_history, want.energy_history,
                               atol=TOL, rtol=0)
    with pytest.raises(ValueError, match="no parameters"):
        VQE(IdealEstimator(device="cpu"), Circuit(1).h(0))
    with pytest.raises(ValueError, match="unknown optimizer"):
        VQE(IdealEstimator(device="cpu"), ansatz, optimizer="adam"
            ).compute_minimum_eigenvalue(PauliSum("Z"))

