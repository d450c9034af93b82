"""Port vs JAX package: per-op unitaries and the statevector engine.

The port batches natively where the JAX package vmaps one circuit at a
time: a template batch shares one qubit index set, a stacked batch gathers
with per-circuit indices. Both are held to the JAX engine at 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlqem_tpu.circuits import circuit as jc
from mlqem_tpu.circuits import families as jf
from mlqem_tpu.circuits import observables as jo
from mlqem_tpu.circuits.gates import GATE_NAMES
from mlqem_tpu.ops import statevector as jsv
from mlqem_tpu.ops import unitaries as ju
from mlqem_tpu.parallel.datagen import make_ising_template as j_template

from mlqem_tpu_torch.circuits import circuit as tc
from mlqem_tpu_torch.circuits import families as tf
from mlqem_tpu_torch.circuits import observables as to
from mlqem_tpu_torch.ops import statevector as tsv
from mlqem_tpu_torch.ops import unitaries as tu
from mlqem_tpu_torch.parallel.datagen import make_ising_template

from port_fixtures import one_torch_thread  # noqa: F401


def test_op_unitaries_every_gate_kind(rng):
    gate_ids = np.arange(len(GATE_NAMES), dtype=np.int32)      # all 34
    params = rng.uniform(-3, 3, size=(len(gate_ids), 3)).astype(np.float32)
    want = np.asarray(ju.op_unitaries(jnp.asarray(gate_ids),
                                      jnp.asarray(params)))
    got = tu.op_unitaries(gate_ids, torch.as_tensor(params))
    assert got.dtype == torch.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # batched params broadcast against shared gate ids
    batch = rng.uniform(-3, 3, size=(3, len(gate_ids), 3)).astype(np.float32)
    got_b = tu.op_unitaries(gate_ids, torch.as_tensor(batch))
    for i in range(3):
        want_i = ju.op_unitaries(jnp.asarray(gate_ids), jnp.asarray(batch[i]))
        np.testing.assert_allclose(got_b[i].numpy(), np.asarray(want_i),
                                   atol=1e-6, rtol=0)


def test_bit_helpers_match_jax(rng):
    for n in (2, 3, 6):
        for a in range(n):
            for b in range(n):
                if a == b:
                    continue
                np.testing.assert_array_equal(
                    tu.pair_indices(a, b, n).numpy(),
                    np.asarray(ju.pair_indices(jnp.int32(a), jnp.int32(b), n)))
    v = rng.integers(0, 2 ** 31 - 1, size=64).astype(np.int32)
    np.testing.assert_array_equal(tu.popcount(torch.as_tensor(v)).numpy(),
                                  np.asarray(ju.popcount(jnp.asarray(v))))
    np.testing.assert_array_equal(
        tu.insert_bit(torch.arange(16), 2).numpy(),
        np.asarray(ju.insert_bit(jnp.arange(16, dtype=jnp.int32), 2)))


def _random_circuits(mod_c, mod_f, nq, count, seed):
    circs = [mod_f.random_circuit(nq, 4, seed=seed + i) for i in range(count)]
    circs.append(mod_c.Circuit(nq).h(0).cx(0, nq - 1).ecr(1, 0)
                 .rxx(0.3, 0, 1).ryy(-0.8, nq - 1, 1).cu3(0.1, 0.2, 0.3, 1, 0))
    return circs


@pytest.mark.parametrize("nq", [1, 2, 5])
def test_single_and_stacked_statevectors(nq):
    if nq == 1:
        circs = [tc.Circuit(1).h(0).rx(0.3, 0), tc.Circuit(1).ry(1.2, 0)]
        jcircs = [jc.Circuit(1).h(0).rx(0.3, 0), jc.Circuit(1).ry(1.2, 0)]
    else:
        circs = _random_circuits(tc, tf, nq, 3, seed=nq)
        jcircs = _random_circuits(jc, jf, nq, 3, seed=nq)
    # one circuit
    want = np.asarray(jsv.statevector(jc.tensorize(jcircs[0])))
    got = tsv.statevector(tc.tensorize(circs[0]), device="cpu")
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # a stacked batch: each circuit with its own qubits (per-row gathers)
    ct = tc.stack_circuits(circs)
    assert np.asarray(ct.qubits).ndim == 3
    want_b = np.asarray(jsv.batch_statevectors(jc.stack_circuits(jcircs)))
    got_b = tsv.batch_statevectors(ct, device="cpu")
    np.testing.assert_allclose(got_b.numpy(), want_b, atol=1e-5, rtol=0)


@pytest.mark.parametrize("h", [1.0, None])
def test_template_batch_shares_qubits(h, rng):
    tpl = make_ising_template(5, 2, "Z", 0.25, h=h)
    jtpl = j_template(5, 2, "Z", 0.25, h=h)
    values = rng.uniform(0.05, 1.0, size=(6, tpl.num_parameters)
                         ).astype(np.float32)
    ct = tpl.bind(torch.as_tensor(values))
    assert np.asarray(ct.qubits).ndim == 2           # one index set
    got = tsv.statevector(ct, device="cpu")
    jct = jtpl.bind(jnp.asarray(values))
    want = jax.vmap(lambda p: jsv.statevector(
        jc.CircuitTensor(jct.gate_ids, jct.qubits, p, 5)))(jct.params)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    # the same batch through per-row indices gives the same states
    per_row = tc.CircuitTensor(
        np.broadcast_to(ct.gate_ids, (6,) + ct.gate_ids.shape),
        np.broadcast_to(ct.qubits, (6,) + ct.qubits.shape), ct.params, 5)
    np.testing.assert_array_equal(
        tsv.statevector(per_row, device="cpu").numpy(), got.numpy())


def test_expectations_match_jax(rng):
    nq = 4
    circs = _random_circuits(tc, tf, nq, 3, seed=20)
    jcircs = _random_circuits(jc, jf, nq, 3, seed=20)
    states = tsv.batch_statevectors(tc.stack_circuits(circs), device="cpu")
    jstates = jsv.batch_statevectors(jc.stack_circuits(jcircs))
    probs = tsv.probabilities(states)
    jprobs = jsv.probabilities(jstates)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-5)
    np.testing.assert_allclose(tsv.z_expectations(probs, nq).numpy(),
                               np.asarray(jsv.z_expectations(jprobs, nq)),
                               atol=1e-5)
    np.testing.assert_allclose(tsv.all_z_expectation(probs, nq).numpy(),
                               np.asarray(jsv.all_z_expectation(jprobs, nq)),
                               atol=1e-5)
    obs = to.random_pauli_sum(nq, 5, seed=1)
    jobs = jo.random_pauli_sum(nq, 5, seed=1)
    np.testing.assert_allclose(
        tsv.expval_pauli_sum(states, obs).numpy(),
        np.asarray(jsv.expval_pauli_sum(jstates, jobs)), atol=1e-5)
    np.testing.assert_allclose(
        tsv.ideal_expectation_values(circs, obs, device="cpu"),
        jsv.ideal_expectation_values(jcircs, jobs), atol=1e-5)
    per = [to.single_z(q % nq, nq) for q in range(len(circs))]
    jper = [jo.single_z(q % nq, nq) for q in range(len(circs))]
    np.testing.assert_allclose(
        tsv.ideal_expectation_values(circs, per, device="cpu"),
        jsv.ideal_expectation_values(jcircs, jper), atol=1e-5)


def test_bell_state_closed_form():
    psi = tsv.statevector(tc.tensorize(tc.Circuit(2).h(0).cx(0, 1)),
                          device="cpu")
    for pauli, want in (("ZZ", 1.0), ("XX", 1.0), ("YY", -1.0),
                        ("ZI", 0.0)):
        got = tsv.expval_pauli_sum(psi, to.PauliSum(pauli))
        assert abs(float(got) - want) < 1e-6, pauli


def test_entry_points_run_on_the_card_unless_asked():
    """The statevector entry points default to the card, as every other
    entry point of the port does, and convert.py names no default device."""
    import inspect

    from mlqem_tpu_torch import convert

    for fn in (tsv.zero_state, tsv.statevector, tsv.batch_statevectors,
               tsv.ideal_expectation_values):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    for fn in (convert.engine_tables_from_numpy,
               convert.pipeline_tables_from_numpy):
        assert (inspect.signature(fn).parameters["device"].default
                is inspect.Parameter.empty)
    # a tensor's device still decides, with or without ``device``
    ct = tc.tensorize(tc.Circuit(2).h(0).cx(0, 1))
    ct.params = torch.as_tensor(np.asarray(ct.params, np.float32))
    assert tsv.statevector(ct).device.type == "cpu"
