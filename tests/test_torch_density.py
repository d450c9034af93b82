"""Port vs JAX package: the exact density-matrix engines, shot sampling,
the static statevector engine, the batch trajectory engine and
``IsingLabelPipeline(method="density_matrix")``.

Inputs are made by numpy from a seed and handed to both packages; the noise
is the asymmetric calibrated noise of ``configurable_device(nq, seed=0)``
(or fake_lima's), which a slot-order bug would not survive. The engines
draw nothing, so they are held exactly (1e-6, f32 reassociation); sampled
outputs are held within 5 standard errors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlqem_tpu.ops.sampling as j_sampling
from mlqem_tpu.circuits.circuit import Circuit as JCircuit
from mlqem_tpu.circuits.circuit import stack_circuits as j_stack
from mlqem_tpu.circuits.circuit import tensorize as j_tensorize
from mlqem_tpu.circuits.observables import PauliSum as JPauliSum
from mlqem_tpu.device.noise import NoiseModel as JNoiseModel
from mlqem_tpu.device.noise import compile_noise_table as j_compile
from mlqem_tpu.device.registry import configurable_device as j_configurable
from mlqem_tpu.device.registry import get_device as j_get_device
from mlqem_tpu.ops import density as jd
from mlqem_tpu.ops import density_static as jds
from mlqem_tpu.ops import static_sv as jsv
from mlqem_tpu.ops.channels import depolarizing_channel
from mlqem_tpu.ops.trajectory import _batch_trajectories as j_batch_traj
from mlqem_tpu.ops.unitaries import op_unitaries as j_op_unitaries
from mlqem_tpu.parallel.datagen import IsingLabelPipeline as JPipeline
from mlqem_tpu.parallel.datagen import make_ising_template as j_template

import mlqem_tpu_torch.ops.sampling as t_sampling
from mlqem_tpu_torch import (Circuit, IsingLabelPipeline, NoiseModel,
                             PauliSum, configurable_device, get_device,
                             stack_circuits, tensorize)
from mlqem_tpu_torch.circuits.gates import GATE_NAMES, GATE_NUM_QUBITS
from mlqem_tpu_torch.convert import density_from_numpy, noise_table_from_numpy
from mlqem_tpu_torch.device.noise import compile_noise_table
from mlqem_tpu_torch.ops import density as td
from mlqem_tpu_torch.ops import density_static as tds
from mlqem_tpu_torch.ops import static_sv as tsv
from mlqem_tpu_torch.ops.trajectory import (_batch_trajectories,
                                            run_trajectories,
                                            trajectory_z_labels,
                                            twirled_noise_tables)
from mlqem_tpu_torch.ops.unitaries import op_unitaries
from mlqem_tpu_torch.parallel.datagen import make_ising_template
from mlqem_tpu_torch.utils.profiling import reset_spans, span_totals, tracing

from port_fixtures import one_torch_thread  # noqa: F401

TOL = 1e-6


def _template_case(nq, steps, batch, seed):
    """The Ising template in both packages, its noise table and params."""
    jt = j_template(nq, steps, "Z", 0.25, h=1.0)
    jct = jt.bind_host(np.zeros(jt.num_parameters, np.float32))
    keys, table = j_compile(jct, JNoiseModel.from_device(
        j_configurable(nq, seed=0)))
    t = make_ising_template(nq, steps, "Z", 0.25, h=1.0)
    ct = t.bind_host(np.zeros(t.num_parameters, np.float32))
    params = np.random.default_rng(seed).uniform(
        -1.0, 1.0, size=(batch,) + ct.params.shape).astype(np.float32)
    return jct, ct, keys, table, params


def _jax_dm(jct, params, keys, table):
    """JAX's unfused template engine at its CPU default, compiled as one
    program (its eager form compiles every op on its own)."""
    return np.asarray(jax.jit(lambda p: jds.run_density_static(
        jct, p, keys, table, fuse=False))(jnp.asarray(params)))


def _jax_plan(jct, keys, table, params, nq):
    """JAX's fused plan [(a, b, s16)], its superops compiled as one
    program; the qubit pairs are fixed on the host while it traces."""
    pairs = []

    def plan(p):
        mats = jax.vmap(lambda q: j_op_unitaries(
            jnp.asarray(jct.gate_ids), q))(p)
        ops = jds.fuse_superops(jds.static_pairs(jct),
                                np.asarray(jct.gate_ids),
                                np.asarray(keys).reshape(-1),
                                np.asarray(table, np.complex64), mats,
                                params.shape[0], nq, jnp.complex64)
        pairs[:] = [(a, b) for a, b, _ in ops]
        return [s for _, _, s in ops]

    s16s = jax.jit(plan)(jnp.asarray(params))
    return [(a, b, s) for (a, b), s in zip(pairs, s16s)]


@pytest.mark.parametrize("nq", [3, 4, 5])
def test_run_density_static_matches_jax(nq):
    """Unfused, fused and 4-qubit-paired sweeps against JAX's unfused
    engine at its CPU default."""
    jct, ct, keys, table, params = _template_case(nq, 2, 3, seed=nq)
    want = _jax_dm(jct, params, keys, table)
    keys_t, table_t = noise_table_from_numpy(keys, table, "cpu")
    for fuse, pair4 in ((False, False), (True, False), (True, True)):
        got = tds.run_density_static(ct, torch.as_tensor(params), keys_t,
                                     table_t, fuse=fuse, pair4=pair4)
        assert got.shape == want.shape and got.dtype == torch.complex64
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0,
                                   err_msg=f"fuse={fuse} pair4={pair4}")
    tr = np.trace(got.numpy(), axis1=1, axis2=2)
    np.testing.assert_allclose(tr, 1.0, atol=1e-5)


@pytest.mark.parametrize("nq,steps", [(4, 2), (5, 2), (10, 4)])
def test_fused_plan_matches_jax(nq, steps):
    """fuse_superops emits as many superops as JAX's, each equal; the
    bench template (nq 10, 4 steps) fuses its 148 slots into 36, one per
    bond and step (the trailing rx layer merges into the last bonds)."""
    jct, ct, keys, table, params = _template_case(nq, steps, 2, seed=1)
    want = _jax_plan(jct, keys, table, params, nq)
    got = tds.fuse_superops(tds.static_pairs(ct), ct.gate_ids,
                            keys.reshape(-1), table,
                            op_unitaries(ct.gate_ids,
                                         torch.as_tensor(params)), 2, nq)
    assert len(got) == len(want)
    for (a, b, s), (ja, jb, js) in zip(got, want):
        assert (a, b) == (ja, jb)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=TOL)
    if (nq, steps) == (10, 4):
        assert ct.max_ops == 148 and len(got) == 9 * 4
    pairs = tds.pair_disjoint_superops(got)
    want_pairs = jds.pair_disjoint_superops(want)
    assert [e[:-1] for e in pairs] == [e[:-1] for e in want_pairs]


@pytest.mark.parametrize("a,b", [(0, 1), (1, 0), (2, 4), (4, 2), (0, 4),
                                 (3, 2)])
def test_apply_superop_static_both_orientations(a, b):
    rng = np.random.default_rng(10 * a + b)
    n, dim = 5, 32
    dm = (rng.normal(size=(2, dim, dim))
          + 1j * rng.normal(size=(2, dim, dim))).astype(np.complex64)
    s16 = (rng.normal(size=(2, 16, 16))
           + 1j * rng.normal(size=(2, 16, 16))).astype(np.complex64)
    want = np.asarray(jds.apply_superop_static(
        jnp.asarray(dm), jnp.asarray(s16), a, b, n, "einsum"))
    for variant in ("transpose", "einsum"):
        got = tds.apply_superop_static(torch.as_tensor(dm),
                                       torch.as_tensor(s16), a, b, n,
                                       variant)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    with pytest.raises(ValueError, match="variant"):
        tds.apply_superop_static(torch.as_tensor(dm), torch.as_tensor(s16),
                                 a, b, n, "transpose_carry")


def _same_circuit(build):
    jc, c = JCircuit(3), Circuit(3)
    build(jc)
    build(c)
    return jc, c


def test_fusion_reversed_orientation_and_padding():
    """cx(0,1) then cx(1,0) merge across orientations; NOP padding skips."""
    def build(c):
        c.h(0).cx(0, 1).rz(0.3, 1).cx(1, 0).rx(0.7, 2).cx(1, 2)

    jc, c = _same_circuit(build)
    jct, ct = j_tensorize(jc, max_ops=12), tensorize(c, max_ops=12)
    keys, table = j_compile(jct, JNoiseModel.from_device(
        j_configurable(3, seed=0)))
    params = np.broadcast_to(np.asarray(ct.params), (2,) + ct.params.shape)
    want = _jax_dm(jct, params, keys, table)
    for fuse in (False, True):
        got = tds.run_density_static(ct, torch.as_tensor(params.copy()),
                                     keys, table, fuse=fuse)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    plan = tds.fuse_superops(tds.static_pairs(ct), ct.gate_ids,
                             keys.reshape(-1), table, op_unitaries(
                                 ct.gate_ids, torch.as_tensor(params.copy())),
                             2, 3)
    assert len(plan) == len(_jax_plan(jct, keys, table, params, 3))


def test_fusion_absorbs_noisy_1q_channels():
    """A 1q gate with its own channel absorbs exactly; a table entry that
    does not factor keeps its op emitted, as in JAX."""
    jc, c = JCircuit(2), Circuit(2)
    for circ in (jc, c):
        circ.sx(0).rz(0.4, 0).cx(0, 1).sx(1)
    jnm = JNoiseModel.from_device(j_configurable(2, seed=0))
    jnm.add_quantum_error(depolarizing_channel(0.02, 1), "sx", (0,))
    jnm.add_quantum_error(depolarizing_channel(0.03, 1), "sx", (1,))
    jct, ct = j_tensorize(jc), tensorize(c)
    keys, table = j_compile(jct, jnm)
    table2 = np.array(table, np.complex64)
    table2[int(keys.reshape(-1)[0])] = depolarizing_channel(0.05, 2).superop()
    params = np.asarray(ct.params, np.float32)[None]
    for tab in (table, table2):
        want = _jax_dm(jct, params, keys, tab)
        got = tds.run_density_static(ct, torch.as_tensor(params), keys, tab)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL)


def _random_circuits(make, nq, count, rng):
    out = []
    for k in range(count):
        c = make(nq)
        c.rx(float(rng.uniform(0, 3)), k % nq).cx(0, 1).ry(0.4, 2)
        c.cx(2, 1).sdg(0).cz(1, 0)
        if k % 2:
            c.h(2).cx(1, 2)               # circuits of different lengths
        out.append(c)
    return out


def test_gather_engine_matches_jax(rng):
    """batch_density_matrices on circuits that differ, and
    batch_density_matrices_from on JAX's states carried across."""
    seed = int(rng.integers(1 << 30))
    jcs = _random_circuits(JCircuit, 3, 4, np.random.default_rng(seed))
    cs = _random_circuits(Circuit, 3, 4, np.random.default_rng(seed))
    jct, ct = j_stack(jcs), stack_circuits(cs)
    jnm = JNoiseModel.from_device(j_get_device("fake_lima"))
    keys, table = j_compile(jct, jnm)
    t_keys, t_table = compile_noise_table(
        ct, NoiseModel.from_device(get_device("fake_lima")))
    np.testing.assert_array_equal(keys, t_keys)
    np.testing.assert_allclose(t_table, table, atol=1e-12)
    want = np.asarray(jd.batch_density_matrices(jct, keys, table))
    got = td.batch_density_matrices(ct, keys, table, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)

    rot = [JCircuit(3).h(0).sdg(1).h(1), JCircuit(3).h(2)]
    t_rot = [Circuit(3).h(0).sdg(1).h(1), Circuit(3).h(2)]
    jrct, rct = j_stack(rot), stack_circuits(t_rot)
    rkeys, rtable = j_compile(jrct, jnm)
    want2 = np.asarray(jd.batch_density_matrices_from(
        jrct, rkeys, rtable, jnp.asarray(want[:2])))
    got2 = td.batch_density_matrices_from(
        rct, rkeys, rtable, density_from_numpy(want[:2], "cpu"))
    np.testing.assert_allclose(got2.numpy(), want2, atol=TOL)

    dm = got2.numpy()
    np.testing.assert_allclose(td.dm_probabilities(got2).numpy(),
                               np.asarray(jd.dm_probabilities(want2)),
                               atol=TOL)
    np.testing.assert_allclose(td.purity(got2).numpy(),
                               np.asarray(jd.purity(want2)), atol=1e-5)
    for pauli in ("ZIX", "YYZ", "XIY", "IZZ"):
        obs = (PauliSum([(pauli, 0.7), ("ZZI", -0.2)]),
               JPauliSum([(pauli, 0.7), ("ZZI", -0.2)]))
        np.testing.assert_allclose(
            td.expval_pauli_sum_dm(torch.as_tensor(dm), obs[0]).numpy(),
            np.asarray(jd.expval_pauli_sum_dm(jnp.asarray(dm), obs[1])),
            atol=1e-5)


def test_state_carriers_refuse_bad_shapes():
    with pytest.raises(ValueError, match="16, 16"):
        noise_table_from_numpy(np.zeros(3, np.int32), np.zeros((2, 4, 4)),
                               "cpu")
    with pytest.raises(ValueError, match="index"):
        noise_table_from_numpy(np.array([0, 2]), np.zeros((2, 16, 16)),
                               "cpu")
    with pytest.raises(ValueError, match="2\\^n"):
        density_from_numpy(np.zeros((2, 8, 4)), "cpu")
    dm = density_from_numpy(np.eye(4)[None] / 4, "cpu")
    assert dm.dtype == torch.complex64 and dm.shape == (1, 4, 4)


@pytest.mark.parametrize("nq", [3, 4, 5])
@pytest.mark.parametrize("readout", [True, False])
def test_dm_pipeline_matches_jax(nq, readout):
    """IsingLabelPipeline's default method, shots=None: (ideal, noisy)
    within 1e-5 of the JAX pipeline's generate."""
    kw = dict(nq=nq, steps=2, dt=0.25, h=1.0, shots=None, readout=readout)
    pipe = IsingLabelPipeline(configurable_device(nq, seed=0), device="cpu",
                              **kw)
    jpipe = JPipeline(j_configurable(nq, seed=0), **kw)
    assert pipe.method == jpipe.method == "density_matrix"
    np.testing.assert_array_equal(pipe._keys, jpipe._keys)
    J = np.random.default_rng(nq).uniform(0.05, 0.6, size=3).astype(
        np.float32)
    ideal, noisy = pipe.generate(J)
    j_ideal, j_noisy = jpipe.generate(J)
    assert ideal.shape == noisy.shape == (3, nq)
    np.testing.assert_allclose(ideal, j_ideal, atol=1e-5, rtol=0)
    np.testing.assert_allclose(noisy, j_noisy, atol=1e-5, rtol=0)
    assert np.abs(noisy - ideal).max() > 1e-3


def test_dm_pipeline_shots_and_stage_marks():
    """Joint shots within 5σ of the exact labels; the stages in order."""
    nq, S = 4, 4000
    kw = dict(nq=nq, steps=2, device="cpu")
    exact = IsingLabelPipeline(configurable_device(nq, seed=0), shots=None,
                               **kw)
    sampled = IsingLabelPipeline(configurable_device(nq, seed=0), shots=S,
                                 **kw)
    J = np.random.default_rng(3).uniform(0.05, 0.6, size=6)
    _, z = exact.generate(J)
    _, zs = sampled.generate(J, seed=5)
    sigma = np.sqrt(np.clip(1.0 - z ** 2, 0.0, None) / S)
    assert np.all(np.abs(zs - z) <= 5 * sigma + 1e-6)
    assert not np.array_equal(zs, z)
    reset_spans()
    with tracing():
        sampled.run(torch.tensor([[0.3], [0.5]]),
                    torch.Generator().manual_seed(0))
    assert list(span_totals()) == ["pipeline.frame", "pipeline.evolve",
                                   "pipeline.readout", "pipeline.ideal"]


def test_sample_outcomes_histogram_within_five_sigma():
    probs = np.random.default_rng(4).dirichlet(np.ones(16), size=2)
    n = 200_000
    gen = torch.Generator().manual_seed(9)
    hist = t_sampling.sample_histogram(torch.as_tensor(probs), n, 16, gen)
    assert hist.dtype == torch.int32 and hist.shape == (2, 16)
    assert (hist.sum(-1) == n).all()
    sigma = np.sqrt(n * probs * (1 - probs))
    assert np.all(np.abs(hist.numpy() - n * probs) <= 5 * sigma)
    out = t_sampling.sample_outcomes(torch.as_tensor(probs), 100, gen)
    assert out.dtype == torch.int32 and out.shape == (2, 100)
    # a zero-probability tail is never drawn, and the last index clamps
    p = torch.tensor([0.5, 0.5, 0.0, 0.0])
    assert t_sampling.sample_outcomes(p, 5000, gen).max() <= 1
    zs = t_sampling.sampled_z_expectations(torch.as_tensor(probs), n, 4, gen)
    z = np.asarray(jnp.stack([j_sampling.expectation_from_probs(
        jnp.asarray(probs), 1 << q) for q in range(4)], -1))
    np.testing.assert_allclose(
        t_sampling.expectation_from_probs(torch.as_tensor(probs), 5).numpy(),
        np.asarray(j_sampling.expectation_from_probs(jnp.asarray(probs), 5)),
        atol=1e-6)                      # the JAX side runs in f32
    assert np.all(np.abs(zs.numpy() - z) <= 5 / np.sqrt(n))
    par = t_sampling.sampled_parity_expectation(torch.as_tensor(probs), n, 6,
                                                gen).numpy()
    want = np.asarray(j_sampling.expectation_from_probs(jnp.asarray(probs),
                                                        6))
    assert np.all(np.abs(par - want) <= 5 / np.sqrt(n))
    counts = t_sampling.histogram_to_counts(hist[0].numpy(), 4)
    assert counts == j_sampling.histogram_to_counts(hist[0].numpy(), 4)
    np.testing.assert_array_equal(t_sampling.counts_to_probs(counts, 4),
                                  j_sampling.counts_to_probs(counts, 4))


def test_static_statevector_engine_matches_jax():
    """The JAX template names, batch-first and batch-last, ideal and on
    shared Pauli draws. A 1q op's noise leaves its embedding partner alone
    (index 4·p_a + 0), as a 1q channel's does: JAX's batch-last engine
    applies only the 2x2 block of a 1q op."""
    jct, ct, _, _, params = _template_case(5, 2, 3, seed=2)
    p = torch.as_tensor(params)
    choices = np.random.default_rng(0).integers(
        0, 16, size=(3, 4, ct.max_ops)).astype(np.int32)
    one_q = np.array([GATE_NUM_QUBITS.get(GATE_NAMES[int(g)], 1) == 1
                      for g in ct.gate_ids])
    choices[..., one_q] &= ~3
    want, want_last, want_t, want_t_last = jax.jit(lambda q, c: (
        jsv.run_static(jct, q), jsv.run_static_tlast(jct, q),
        jsv.run_trajectories_static(jct, q, c, 4),
        jsv.run_trajectories_tlast(jct, q, c, 4)))(
            jnp.asarray(params), jnp.asarray(choices))
    np.testing.assert_allclose(tsv.run_static(ct, p).numpy(), want,
                               atol=1e-5)
    np.testing.assert_allclose(tsv.run_static_tlast(ct, p).numpy(),
                               want_last, atol=1e-5)
    assert tsv.static_pairs(ct) == jsv.static_pairs(jct)
    c = torch.as_tensor(choices)
    np.testing.assert_allclose(tsv.run_trajectories_static(
        ct, p, c, 4).numpy(), want_t, atol=1e-5)
    np.testing.assert_allclose(tsv.run_trajectories_tlast(
        ct, p, c, 4).numpy(), want_t_last, atol=1e-5)
    with pytest.raises(ValueError, match="n_traj"):
        tsv.run_trajectories_static(ct, p, c, 5)


def test_batch_trajectories_match_jax_on_shared_draws(monkeypatch):
    """Circuits that differ, one draw table for all: the states match.
    The JAX function traces its draws once per shape, so the same
    (L, T) draws go to every circuit."""
    nq, T = 3, 5
    jcs = _random_circuits(JCircuit, nq, 3, np.random.default_rng(1))
    cs = _random_circuits(Circuit, nq, 3, np.random.default_rng(1))
    jct, ct = j_stack(jcs), stack_circuits(cs)
    pp = twirled_noise_tables(ct, NoiseModel.from_device(
        get_device("fake_lima")))
    L = ct.max_ops
    draws = np.random.default_rng(2).integers(0, 16, size=(T, L)).astype(
        np.int32)
    monkeypatch.setattr(j_sampling, "sample_small_categorical",
                        lambda key, probs, shape: jnp.asarray(draws.T))
    monkeypatch.setattr(t_sampling, "sample_small_categorical",
                        lambda probs, shape, gen: torch.as_tensor(
                            np.broadcast_to(draws, shape).copy()))
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    want = np.asarray(j_batch_traj(
        jnp.asarray(jct.gate_ids), jnp.asarray(jct.qubits),
        jnp.asarray(jct.params), jnp.asarray(pp), keys, T, nq))
    gen = torch.Generator().manual_seed(0)
    got = _batch_trajectories(ct.gate_ids, ct.qubits, ct.params, pp, gen, T,
                              nq)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    one = run_trajectories(tensorize(cs[1], L), pp[1], T, gen)
    np.testing.assert_allclose(one.numpy(), want[1], atol=1e-5)


def test_trajectory_z_labels_against_exact_dm():
    """Trajectory labels (Pauli-twirled noise) within statistics plus the
    twirl's bias of the exact noisy labels; shots add only noise."""
    nq = 3
    cs = _random_circuits(Circuit, nq, 2, np.random.default_rng(3))
    ct = stack_circuits(cs)
    nm = NoiseModel.from_device(get_device("fake_lima"))
    keys, table = compile_noise_table(ct, nm)
    probs = td.dm_probabilities(td.batch_density_matrices(ct, keys, table,
                                                          device="cpu"))
    from mlqem_tpu_torch.ops.statevector import z_expectations
    exact = z_expectations(probs, nq).numpy()
    T = 4000
    z = trajectory_z_labels(ct, nm, T, None, seed=1, device="cpu")
    assert z.shape == (2, nq)
    assert np.abs(z - exact).max() < 5 / np.sqrt(T) + 0.01
    zs = trajectory_z_labels(ct, nm, 400, 10, seed=1, device="cpu",
                             readout=nm.readout[:nq])
    assert zs.shape == (2, nq) and np.all(np.abs(zs) <= 1)
