"""Port vs JAX package: the sparse Pauli-propagation engine.

The term words are compared as uint32 (the port keeps them in int32, whose
bit 31 is the sign bit), bit for bit, across the word boundary (qubits 31
and 32 of a 40-qubit chain); coefficients within 1e-6. Without discards the
engine's values are held to JAX's within 1e-6. With discards, in the
tie-heavy Clifford-kick case (θ_h = π/2 splits every term into an
equal-magnitude pair), both sides keep the same terms (the first K of a
stable descending sort, as ``lax.top_k`` keeps them), so the values there
too are held within 1e-6; a discarded weight within 1e-5 (JAX subtracts
two f32 sums, the port sums the discarded tail).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlqem_tpu.ops.pauli_prop as jpp
from mlqem_tpu.device.registry import configurable_device as j_configurable

import mlqem_tpu_torch.ops.pauli_prop as tpp
from mlqem_tpu_torch import NoiseModel, configurable_device, get_device
from mlqem_tpu_torch.circuits.circuit import stack_circuits
from mlqem_tpu_torch.circuits.families import IsingModel, IsingOptions
from mlqem_tpu_torch.device.noise import compile_noise_table
from mlqem_tpu_torch.ops.channels import depolarizing_channel
from mlqem_tpu_torch.ops.density import (batch_density_matrices,
                                         dm_probabilities)
from mlqem_tpu_torch.ops.statevector import z_expectations

from port_fixtures import one_torch_thread  # noqa: F401

VAL_TOL = 1e-6
DISC_TOL = 1e-5
NQ_WIDE, K_OPS = 40, 64
WORD_QUBITS = (0, 31, 32, 39)


def test_host_tables_equal():
    for name in ("_CX_CODES", "_CX_SIGNS", "_ZZ_ANTI", "_ZZ_NEW", "_ZZ_SIGN",
                 "_X_ANTI", "_X_NEW", "_X_SIGN", "_Z_ANTI", "_Z_NEW",
                 "_Z_SIGN"):
        got, want = getattr(tpp, name), getattr(jpp, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for c in range(16):
        np.testing.assert_array_equal(tpp._code_mat(c), jpp._code_mat(c))


def test_damping_tables_equal():
    """Per-bond damping f = w @ pauli_channel_probs(chan), on the
    asymmetric calibrated channels of configurable_device(10)."""
    got = tpp.PauliPropagatorIsing(configurable_device(10, seed=0), nq=10,
                                   steps=1, device="cpu")
    want = jpp.PauliPropagatorIsing(j_configurable(10, seed=0), nq=10,
                                    steps=1)
    assert got.bonds == want.bonds
    for b in want.bonds:
        np.testing.assert_allclose(got._f_local[b], want._f_local[b],
                                   atol=1e-7, rtol=0)
    np.testing.assert_array_equal(got._readout, want._readout)


def _term_sets(seed):
    """Random term sets [K, W] at nq 40: uint32 words, coefficients from a
    small set (ties and zeros), as the JAX and the port types."""
    rng = np.random.default_rng(seed)
    W = (NQ_WIDE + 31) // 32
    x = rng.integers(0, 2 ** 32, size=(K_OPS, W), dtype=np.uint64
                     ).astype(np.uint32)
    z = rng.integers(0, 2 ** 32, size=(K_OPS, W), dtype=np.uint64
                     ).astype(np.uint32)
    x[:, -1] &= (1 << (NQ_WIDE - 32)) - 1
    z[:, -1] &= (1 << (NQ_WIDE - 32)) - 1
    coeff = rng.choice([0.0, 0.25, -0.25, 0.5, -0.5, 0.125],
                       size=K_OPS).astype(np.float32)
    j = jpp.TermSet(jnp.asarray(x), jnp.asarray(z), jnp.asarray(coeff))
    t = tpp.TermSet(torch.as_tensor(x.view(np.int32)),
                    torch.as_tensor(z.view(np.int32)),
                    torch.as_tensor(coeff))
    return j, t


def _same_terms(got, want):
    np.testing.assert_array_equal(got.x.numpy().view(np.uint32),
                                  np.asarray(want.x))
    np.testing.assert_array_equal(got.z.numpy().view(np.uint32),
                                  np.asarray(want.z))
    np.testing.assert_allclose(got.coeff.numpy(), np.asarray(want.coeff),
                               atol=VAL_TOL, rtol=0)


@pytest.mark.parametrize("q", WORD_QUBITS)
def test_term_ops_bit_equal_across_words(q):
    j, t = _term_sets(q)
    b = q - 1 if q == NQ_WIDE - 1 else q + 1
    np.testing.assert_array_equal(tpp.local_code(t.x, t.z, q).numpy(),
                                  np.asarray(jpp.local_code(j.x, j.z, q)))
    code = torch.arange(K_OPS) % 4
    jx, jz = jpp._write_code(j.x, j.z, q, jnp.asarray(code.numpy()))
    tx, tz = tpp._write_code(t.x, t.z, q, code)
    _same_terms(tpp.TermSet(tx, tz, t.coeff), jpp.TermSet(jx, jz, j.coeff))
    _same_terms(tpp.conj_cx(t, q, b), jpp.conj_cx(j, q, b))
    f = np.random.default_rng(q).uniform(-1, 1, 16).astype(np.float32)
    _same_terms(tpp.damp_pauli_channel(t, q, b, torch.as_tensor(f)),
                jpp.damp_pauli_channel(j, q, b, jnp.asarray(f)))
    # the splits keep K of 2K candidates: ties and zeros decide the order
    theta = np.float32(0.5 * np.pi)
    for name, args in (("rot_x", (q,)), ("rot_z", (q,)), ("rot_zz", (q, b))):
        got, gd = getattr(tpp, name)(t, *args, theta, K_OPS)
        def split(x, z, c, th):
            ts, d = getattr(jpp, name)(jpp.TermSet(x, z, c), *args, th,
                                       K_OPS)
            return ts.x, ts.z, ts.coeff, d

        *want, wd = jax.jit(split)(j.x, j.z, j.coeff, theta)
        _same_terms(got, jpp.TermSet(*want))
        assert abs(float(gd) - float(wd)) <= DISC_TOL, name
    np.testing.assert_allclose(float(tpp.expectation_zero_state(t)),
                               float(jpp.expectation_zero_state(j)),
                               atol=VAL_TOL, rtol=0)


def test_batched_rows_equal_single_rows():
    """The engine's [R, K, W] rows: each row as its own term set."""
    sets = [_term_sets(s)[1] for s in range(3)]
    batched = tpp.TermSet(*(torch.stack([getattr(s, f) for s in sets])
                            for f in ("x", "z", "coeff")))
    theta = np.float32([0.3, -1.1, 0.7])
    got, disc = tpp.rot_zz(batched, 31, 32, theta, K_OPS)
    for r, s in enumerate(sets):
        want, d = tpp.rot_zz(s, 31, 32, theta[r], K_OPS)
        assert torch.equal(got.x[r], want.x) and torch.equal(got.z[r],
                                                             want.z)
        assert torch.equal(got.coeff[r], want.coeff)
        assert float(disc[r]) == float(d)


def _both(nq, steps, h, K, noise, dev_seed=0):
    kw = dict(nq=nq, steps=steps, dt=0.5, h=h, max_terms=K, noise=noise)
    return (tpp.PauliPropagatorIsing(configurable_device(nq, seed=dev_seed),
                                     device="cpu", **kw),
            jpp.PauliPropagatorIsing(j_configurable(nq, seed=dev_seed), **kw))


@pytest.mark.parametrize("arm", ["ideal", "nf1", "nf3"])
def test_stepwise_matches_jax_without_discards(arm):
    """nq 6, 3 steps, readout on: K large enough that nothing is dropped."""
    J = np.array([0.15, 0.4], np.float32)
    got, want = _both(6, 3, 1.0, 4096, noise=arm != "ideal")
    nf = 1 if arm == "ideal" else int(arm[2:])
    v, d = got.generate_stepwise(J, nf, [0, 3, 5])
    wv, wd = want.generate_stepwise(J, nf, [0, 3, 5])
    assert v.shape == d.shape == (2, 3, 3)
    assert float(d.max()) == 0.0
    np.testing.assert_allclose(v, wv, atol=VAL_TOL, rtol=0)
    np.testing.assert_allclose(d, wd, atol=DISC_TOL, rtol=0)
    lv, ld = got.generate(J, nf, [0, 3, 5])
    np.testing.assert_array_equal(lv, v[:, -1])
    np.testing.assert_array_equal(ld, d[:, -1])


def test_truncating_tie_heavy_case_matches_jax():
    """h = 0.5π (the Clifford kick: every RX split is an equal-magnitude
    pair), nq 12, K 256, 5 steps, noisy: the top-K keeps the same terms as
    ``lax.top_k``, so the values agree to f32 summation order."""
    J = np.array([0.1, 0.4], np.float32)
    got, want = _both(12, 5, 0.5 * np.pi, 256, noise=True)
    v, d = got.generate_stepwise(J, 1, [0, 5, 11])
    wv, wd = want.generate_stepwise(J, 1, [0, 5, 11])
    assert float(d.max()) > 0.1          # it does truncate
    np.testing.assert_allclose(v, wv, atol=VAL_TOL, rtol=0)
    np.testing.assert_allclose(d, wd, atol=DISC_TOL, rtol=0)


def test_stable_sort_keeps_the_lower_index():
    mag = torch.tensor([1., 3, 3, 2, 3, 1, 3])
    idx = torch.sort(mag, descending=True, stable=True).indices[:3]
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(jax.lax.top_k(jnp.asarray(mag.numpy()),
                                              3)[1]))


def _dm_reference(nq, steps, dt, J_values, nm):
    circs = [IsingModel.make_circs_sweep(
        IsingOptions(nq=nq, h=1.0, J=float(j), dt=dt), steps, "Z",
        measure=False) for j in J_values]
    ct = stack_circuits(circs)
    keys, table = compile_noise_table(ct, nm)
    return z_expectations(dm_probabilities(batch_density_matrices(
        ct, keys, table, device="cpu")), nq).numpy()


def test_pauli_noise_exact_small():
    """Against the port's exact density-matrix path at nq 4 (the JAX
    package's ``test_pauli_noise_exact_small``)."""
    J = np.array([0.15, 0.4], np.float32)
    nm = NoiseModel(4).add_all_qubit_quantum_error(
        depolarizing_channel(0.03, 2), "cx")
    pp = tpp.PauliPropagatorIsing(get_device("fake_lima"), nq=4, steps=3,
                                  dt=0.5, max_terms=2048, noise_model=nm,
                                  readout=False, device="cpu")
    vals, _ = pp.generate(J)
    np.testing.assert_allclose(vals, _dm_reference(4, 3, 0.5, J, nm),
                               atol=1e-4, rtol=0)


def test_row_chunks_equal_one_call(monkeypatch):
    """Rows chunked by bytes give the values of one call, exactly."""
    J = np.array([0.1, 0.25, 0.4], np.float32)
    pp = tpp.PauliPropagatorIsing(get_device("fake_lima"), nq=4, steps=3,
                                  dt=0.5, max_terms=512, device="cpu")
    full = pp.generate_stepwise(J, noise_scale=1)
    per_row = 2 * pp.K * (16 * pp.W + 40)
    monkeypatch.setattr(tpp, "_CALL_BYTES", 5 * per_row)    # ragged chunks
    chunked = pp.generate_stepwise(J, noise_scale=1)
    for a, b in zip(chunked, full):
        np.testing.assert_array_equal(a, b)
