"""Port vs JAX package: the K-doubling audit of the Pauli-propagation
truncation (``truncation_convergence``), at the JAX package's own test size.
The per-step drifts are held within 1e-6 (both engines keep the same terms
at every K; ``tests/test_torch_pauli_prop.py``)."""
import numpy as np
import pytest

from mlqem_tpu.device.registry import configurable_device as j_configurable
from mlqem_tpu.workflows import demos as jdemos

from mlqem_tpu_torch import configurable_device
from mlqem_tpu_torch.workflows import demos as tdemos

from port_fixtures import one_torch_thread  # noqa: F401

VAL_TOL = 1e-6


def test_truncation_convergence_matches_jax():
    """The K-doubling audit at the JAX package's own test size
    (``tests/test_pauli_prop.py::test_truncation_convergence_audit``)."""
    kw = dict(nq=12, num_steps=4, dt=0.5, h=0.5 * np.pi, J_values=(0.1, 0.4),
              qubits=(0, 5, 11), K_values=(64, 128, 256, 512),
              noise_factors=(0, 1), tol=1e-3)
    got = tdemos.truncation_convergence(configurable_device(12, seed=1),
                                        device="cpu", **kw)
    want = jdemos.truncation_convergence(j_configurable(12, seed=1), **kw)
    assert got.keys() == want.keys()
    for k in ("config", "K_values", "tol", "validated", "validated_depth",
              "K_validated"):
        assert got[k] == want[k], k
    assert got["validated"] and got["K_validated"] == 512
    for arm in want["arms"]:
        drift = np.asarray(got["arms"][arm]["per_step_drift"])
        assert drift.shape == (3, 4)
        np.testing.assert_allclose(
            drift, want["arms"][arm]["per_step_drift"], atol=VAL_TOL, rtol=0)
    assert got["worst_final_pair_drift"] == pytest.approx(
        want["worst_final_pair_drift"], abs=VAL_TOL)
