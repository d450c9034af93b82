"""Port vs JAX package: the VQE study's workflows.

The ansatz draws and the forest's fit are the same host numpy code in both
packages, so the datasets share their circuits and, handed the same
arrays, the forests are identical. The Estimators run with ``shots=None``
(the port's on the CPU), except where the random streams differ: with
shots, values are held to 5 standard errors.
"""
import numpy as np
import pytest

from mlqem_tpu.apps.chemistry import load_h2_problems as j_load_h2
from mlqem_tpu.device.registry import get_device as j_get_device
from mlqem_tpu.workflows import vqe_study as j_study

from mlqem_tpu_torch import get_device, load_h2_problems
from mlqem_tpu_torch.utils.profiling import StageTimer
from mlqem_tpu_torch.workflows import vqe_study

from port_fixtures import one_torch_thread  # noqa: F401

DEV, J_DEV = get_device("fake_lima"), j_get_device("fake_lima")
TOL = 1e-5


@pytest.fixture(scope="module")
def j_data():
    """JAX's dataset at the reference's feature layout (``shots=None``)."""
    return j_study.vqe_dataset(J_DEV, samples_per_pauli=40, shots=None,
                               seed=0)


def test_vqe_dataset_matches_jax(j_data):
    data = vqe_study.vqe_dataset(DEV, samples_per_pauli=40, shots=None,
                                 seed=0, device="cpu")
    assert len(data["circuits"]) == len(j_data["circuits"]) == 200
    assert [c.to_dict() for c in data["circuits"]] == [
        c.to_dict() for c in j_data["circuits"]]
    assert data["meta"] == j_data["meta"]
    assert [o.to_list() for o in data["observables"]] == [
        o.to_list() for o in j_data["observables"]]
    for key in ("ideal", "noisy", "X", "y"):
        assert data[key].shape == np.asarray(j_data[key]).shape, key
        np.testing.assert_allclose(data[key], j_data[key], atol=TOL, rtol=0,
                                   err_msg=key)
    assert data["X"].dtype == data["y"].dtype == np.float32


def test_vqe_dataset_shots_within_five_sigma():
    """With shots the streams differ: both packages' values stay within 5
    standard errors (σ ≤ 1/√shots for a single Pauli) of the exact noisy
    values."""
    shots = 4000
    got = vqe_study.vqe_dataset(DEV, samples_per_pauli=8, shots=shots,
                                seed=3, device="cpu")["noisy"]
    want = j_study.vqe_dataset(J_DEV, samples_per_pauli=8, shots=shots,
                               seed=3)["noisy"]
    exact = vqe_study.vqe_dataset(DEV, samples_per_pauli=8, shots=None,
                                  seed=3, device="cpu")["noisy"]
    for vals in (got, want):
        assert np.all(np.abs(vals - exact) <= 5 / np.sqrt(shots))
    assert not np.array_equal(got, exact)


def test_train_vqe_processor_on_jax_arrays(j_data):
    """Handed JAX's arrays, the port's forest is JAX's: the RMSEs agree to
    1e-6 and the processor predicts on the CPU."""
    arrays = {k: np.asarray(j_data[k]) for k in ("X", "y", "noisy",
                                                 "ideal")}
    proc, stats = vqe_study.train_vqe_processor(DEV, arrays, n_estimators=20,
                                                seed=0, device="cpu")
    _, j_stats = j_study.train_vqe_processor(J_DEV, arrays, n_estimators=20,
                                             seed=0)
    assert set(stats) == set(j_stats) == {"rmse_noisy", "rmse_mitigated"}
    for key in stats:
        assert abs(stats[key] - j_stats[key]) <= 1e-6, key
    assert stats["rmse_mitigated"] < stats["rmse_noisy"]
    assert str(proc._model.device) == "cpu"


def test_vqe_mitigation_study_matches_jax(j_data):
    """One H2 bond, ``shots=None``, COBYLA 30, a 20-tree forest fitted on
    the same (JAX's) arrays in both packages: every arm within 1e-5, and
    mitigation beats the noisy arm."""
    arrays = {k: np.asarray(j_data[k]) for k in ("X", "y", "noisy",
                                                 "ideal")}
    proc, _ = vqe_study.train_vqe_processor(DEV, arrays, n_estimators=20,
                                            device="cpu")
    j_proc, _ = j_study.train_vqe_processor(J_DEV, arrays, n_estimators=20)
    _, _, ham = load_h2_problems()[4]
    _, _, j_ham = j_load_h2()[4]
    out = vqe_study.vqe_mitigation_study(DEV, ham, proc, maxiter=30,
                                         shots=None, device="cpu")
    want = j_study.vqe_mitigation_study(J_DEV, j_ham, j_proc, maxiter=30,
                                        shots=None)
    assert set(out) == set(want)
    for key in out:
        assert abs(out[key] - want[key]) <= TOL, (key, out[key], want[key])
    assert out["error_mitigated"] < out["error_noisy"]


def test_h2_dissociation_curve_rows_and_stages():
    rows = vqe_study.h2_dissociation_curve(DEV, bond_indices=[0, 4],
                                           samples_per_pauli=4, maxiter=10,
                                           shots=None, device="cpu")
    problems = load_h2_problems()
    assert [r["bond_length"] for r in rows] == [problems[0][0],
                                                problems[4][0]]
    for r in rows:
        assert set(r) == {"bond_length", "fci", "exact", "ideal", "noisy",
                          "mitigated", "error_noisy", "error_mitigated"}
        assert all(np.isfinite(v) for v in r.values())
    assert vqe_study.PUBLISHED_H2 == j_study.PUBLISHED_H2
    # the stages of the two functions that take a timer
    timer = StageTimer()
    data = vqe_study.vqe_dataset(DEV, samples_per_pauli=2, shots=None,
                                 device="cpu", timer=timer)
    proc, _ = vqe_study.train_vqe_processor(DEV, data, n_estimators=5,
                                            device="cpu")
    vqe_study.vqe_mitigation_study(DEV, problems[0][2], proc, maxiter=10,
                                   shots=None, device="cpu", timer=timer)
    assert set(timer.totals) == {"estimators", "encode", "arm ideal",
                                 "arm noisy", "arm mitigated"}
    assert all(n == 1 for n in timer.counts.values())
