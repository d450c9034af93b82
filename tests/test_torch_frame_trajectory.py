"""Port vs JAX package: noise tables, the Pauli-frame engines and K2's
plain version.

Both packages take the same ``choices`` (2q Pauli codes per op), made with
numpy, so everything downstream is deterministic and held to float
rounding: the integer frame walk exactly, the state engines at 1e-6 and
the fused marginal path against the JAX kernel in interpret mode at 2e-5
(the JAX package's own tolerance for this path).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlqem_tpu.circuits import circuit as jc
from mlqem_tpu.device import noise as jn
from mlqem_tpu.device.registry import configurable_device as j_configurable
from mlqem_tpu.ops import frame_trajectory as jft
from mlqem_tpu.ops import trajectory as jtr
from mlqem_tpu.ops.density import apply_readout_confusion as j_confusion
from mlqem_tpu.ops.pallas.frame_evolve import \
    evolve_frame_marginals as j_evolve
from mlqem_tpu.ops.statevector import z_expectations as j_z
from mlqem_tpu.parallel.datagen import make_ising_template as j_template

from mlqem_tpu_torch.circuits import circuit as tc
from mlqem_tpu_torch.device import noise as tn
from mlqem_tpu_torch.device.registry import configurable_device
from mlqem_tpu_torch.ops import frame_trajectory as tft
from mlqem_tpu_torch.ops import trajectory as ttr
from mlqem_tpu_torch.ops.density import apply_readout_confusion
from mlqem_tpu_torch.ops.kernels import frame_evolve as fe
from mlqem_tpu_torch.ops.statevector import z_expectations
from mlqem_tpu_torch.parallel.datagen import make_ising_template

from port_fixtures import one_torch_thread  # noqa: F401

G1_FIXED = ["x", "y", "z", "h", "s", "sdg", "t", "tdg", "sx", "sxdg", "id"]
G1_ROT = ["rx", "ry", "rz", "p"]
G2 = ["cx", "cy", "cz", "swap"]


def _random_frame_circuit(mod_c, nq, n_ops, seed, rotations=True):
    """A random circuit over the whole frame gate set (both packages get
    the same circuit from the same seed)."""
    rng = np.random.default_rng(seed)
    qc = mod_c.Circuit(nq)
    kinds = ["1q", "2q"] + (["rot", "rzz"] if rotations else [])
    for _ in range(n_ops):
        kind = kinds[int(rng.integers(len(kinds)))]
        q = int(rng.integers(nq))
        if kind == "1q":
            getattr(qc, G1_FIXED[int(rng.integers(len(G1_FIXED)))])(q)
        elif kind == "rot":
            getattr(qc, G1_ROT[int(rng.integers(4))])(
                float(rng.uniform(-3, 3)), q)
        elif nq >= 2:
            a, b = (int(x) for x in rng.choice(nq, 2, replace=False))
            if kind == "rzz":
                qc.rzz(float(rng.uniform(-3, 3)), a, b)
            else:
                getattr(qc, G2[int(rng.integers(4))])(a, b)
    return qc


def _case(name):
    """(port ct, JAX ct, nq) for the named circuit."""
    if name == "ising":
        tpl, jtpl = (make_ising_template(4, 2, "Z", 0.25, h=1.0),
                     j_template(4, 2, "Z", 0.25, h=1.0))
        zeros = np.zeros(tpl.num_parameters, np.float32)
        return tpl.bind_host(zeros), jtpl.bind_host(zeros), 4
    if name == "id_noise":
        qc = tc.Circuit(3).rx(0.5, 0).id(2).cx(0, 1)
        jqc = jc.Circuit(3).rx(0.5, 0).id(2).cx(0, 1)
        return tc.tensorize(qc), jc.tensorize(jqc), 3
    nq = {"random4": 4, "random5": 5, "random1": 1, "random2": 2,
          "clifford3": 3}[name]
    rot = name != "clifford3"
    return (tc.tensorize(_random_frame_circuit(tc, nq, 24, nq, rot)),
            jc.tensorize(_random_frame_circuit(jc, nq, 24, nq, rot)), nq)


@pytest.mark.parametrize("name", ["ising", "random4", "id_noise"])
def test_noise_tables_match_jax(name):
    ct, jct, nq = _case(name)
    nm = tn.NoiseModel.from_device(configurable_device(max(nq, 2), seed=0))
    jnm = jn.NoiseModel.from_device(j_configurable(max(nq, 2), seed=0))
    keys, table = tn.compile_noise_table(ct, nm)
    jkeys, jtable = jn.compile_noise_table(jct, jnm)
    np.testing.assert_array_equal(keys, jkeys)
    np.testing.assert_allclose(table, jtable, atol=1e-12, rtol=0)
    probs = ttr.twirled_noise_tables(ct, nm)
    assert probs.dtype == np.float32 and probs.shape == (ct.max_ops, 16)
    np.testing.assert_allclose(probs, jtr.twirled_noise_tables(jct, jnm),
                               atol=1e-7, rtol=0)
    for noise in (None, tn.NoiseModel(nq)):
        keys, table = tn.compile_noise_table(ct, noise)
        assert not keys.any() and table.shape == (1, 16, 16)
    np.testing.assert_array_equal(ttr.twirled_noise_tables(ct, None),
                                  jtr.twirled_noise_tables(jct, None))
    ro = tn.readout_matrices(nm, nq)
    np.testing.assert_array_equal(ro, jn.readout_matrices(jnm, nq))
    assert tn.readout_matrices(None, nq) is None


def test_frame_supported_matches_jax():
    for build in (lambda m: m.Circuit(3).h(0).cx(0, 1).crz(0.3, 1, 2),
                  lambda m: m.Circuit(3).rx(0.3, 0).h(1).s(2).cz(0, 2)
                  .swap(1, 2).rzz(0.2, 0, 1),
                  lambda m: m.Circuit(2).u3(0.1, 0.2, 0.3, 0)):
        ct, jct = tc.stack_circuits([build(tc)]), jc.stack_circuits(
            [build(jc)])
        assert tft.frame_supported(ct) == jft.frame_supported(jct)
    assert not tft.frame_supported(ct, 31)


def _choices(rng, B, T, L):
    """Uniform over all 16 codes: every frame path is exercised."""
    return rng.integers(0, 16, size=(B, T, L)).astype(np.int32)


@pytest.mark.parametrize("name", ["ising", "random5", "random1",
                                  "clifford3"])
def test_plan_and_frame_walk_match_jax(name, rng):
    ct, jct, _ = _case(name)
    gids, qubs = np.asarray(ct.gate_ids), np.asarray(ct.qubits)
    plan, meta = tft._build_plan(gids, qubs)
    jplan, jmeta = jft._build_plan(np.asarray(jct.gate_ids),
                                   np.asarray(jct.qubits))
    assert plan == jplan and meta == jmeta
    choices = _choices(rng, 3, 8, ct.max_ops)
    signs, fx = tft._frame_walk(gids, qubs, meta, torch.as_tensor(choices))
    jsigns, jfx = jft._frame_walk(gids, qubs, jmeta, jnp.asarray(choices))
    assert signs.dtype == torch.float32 and fx.dtype == torch.int32
    np.testing.assert_array_equal(signs.numpy(), np.asarray(jsigns))
    np.testing.assert_array_equal(fx.numpy(), np.asarray(jfx))
    assert (fx != 0).any()


@pytest.mark.parametrize("name", ["ising", "random4", "id_noise"])
def test_state_engines_match_jax(name, rng):
    ct, jct, nq = _case(name)
    B, T, L = 2, 8, ct.max_ops
    params = np.repeat(np.asarray(ct.params, np.float32)[None], B, axis=0)
    params[1, :, 0] += rng.uniform(-0.5, 0.5, size=L).astype(np.float32)
    choices = _choices(rng, B, T, L)
    if name == "id_noise":      # an X after the id, on qubit 2
        choices[:] = 0
        choices[:, :, 1] = 4
    got = tft.run_frame_trajectories_probs(ct, torch.as_tensor(params),
                                           torch.as_tensor(choices), nq)
    want = np.asarray(jft.run_frame_trajectories_probs(
        jct, jnp.asarray(params), jnp.asarray(choices), nq))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    states = ttr.run_trajectories_presampled(
        ct, torch.as_tensor(params), torch.as_tensor(choices), nq)
    jstates = jtr.run_trajectories_presampled(
        jct, jnp.asarray(params), jnp.asarray(choices), nq)
    np.testing.assert_allclose(states.numpy(), np.asarray(jstates),
                               atol=1e-6, rtol=0)
    # the two engines agree on the physical distributions
    probs = (states.abs() ** 2).numpy()
    np.testing.assert_allclose(got.numpy(), probs, atol=1e-6, rtol=0)
    if name == "id_noise":
        assert got[0, 0, 4:].sum() > 0.99


@pytest.mark.parametrize("nq,rows", [(1, 3), (2, 5), (5, 7), (6, 4)])
def test_kernel_plain_version_matches_jax_interpret(nq, rows, rng):
    plan, n_rot = fe.every_kind_plan(rng, nq, 24)
    theta = rng.uniform(-3, 3, size=(rows, n_rot)).astype(np.float32)
    got = fe.evolve_frame_marginals(torch.as_tensor(theta), plan, nq)
    want = np.asarray(j_evolve(jnp.asarray(theta), plan, nq,
                               interpret=True))
    assert got.shape == (rows, nq)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_kernel_plain_version_without_rotations(rng):
    """R = 0: the angles are padded to one zero column, as in JAX."""
    plan = ((fe.GATE_H, 0, 1, -1), (fe.GATE_CX, 0, 2, -1),
            (fe.GATE_CY, 2, 1, -1), (fe.GATE_SWAP, 0, 1, -1),
            (fe.GATE_H, 2, 0, -1), (fe.GATE_CZ, 1, 2, -1))
    got = fe.evolve_frame_marginals(torch.zeros((3, 0)), plan, 3)
    want = np.asarray(j_evolve(jnp.zeros((3, 0), jnp.float32), plan, 3,
                               interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("name", ["random4", "clifford3"])
def test_fused_marginals_match_jax_and_probs_path(name, rng):
    ct, jct, nq = _case(name)
    B, T, L = 3, 8, ct.max_ops
    params = np.repeat(np.asarray(ct.params, np.float32)[None], B, axis=0)
    choices = _choices(rng, B, T, L)
    conf = np.stack([np.array([[1 - 0.02 * (q + 1), 0.01 * (q + 1)],
                               [0.02 * (q + 1), 1 - 0.01 * (q + 1)]],
                              np.float32) for q in range(nq)])
    probs = tft.run_frame_trajectories_probs(ct, torch.as_tensor(params),
                                             torch.as_tensor(choices), nq)
    for confusion in (conf, None):
        got = tft.run_frame_trajectories_z(
            ct, torch.as_tensor(params), torch.as_tensor(choices), nq,
            confusion=None if confusion is None else
            torch.as_tensor(confusion))
        want = np.asarray(jft.run_frame_trajectories_z(
            jct, jnp.asarray(params), jnp.asarray(choices), nq,
            confusion=confusion, interpret=True))
        assert got.shape == (B, T, nq)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
        p = probs if confusion is None else apply_readout_confusion(
            probs, torch.as_tensor(confusion), nq)
        np.testing.assert_allclose(got.numpy(), z_expectations(p, nq)
                                   .numpy(), atol=2e-5, rtol=0)
    jp = j_confusion(jnp.asarray(probs.numpy()), jnp.asarray(conf), nq,
                     variant="xor")
    np.testing.assert_allclose(
        z_expectations(apply_readout_confusion(
            probs, torch.as_tensor(conf), nq), nq).numpy(),
        np.asarray(j_z(jp, nq)), atol=1e-6, rtol=0)


def test_wrapper_refuses_bad_plans():
    theta = torch.zeros((2, 1))
    for bad, match in (((9, 0, 1, -1),), "unknown plan kind"), \
            (((fe.GATE_CX, 0, 0, -1),), "qubits"), \
            (((fe.GATE_H, 3, 0, -1),), "qubits"), \
            (((fe.ROT_X, 0, 1, 1),), "slot"):
        with pytest.raises(ValueError, match=match):
            fe.evolve_frame_marginals(theta, bad, 3)
    with pytest.raises(ValueError, match="rows, n_rot"):
        fe.evolve_frame_marginals(torch.zeros(3), (), 3)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fe.evolve_frame_marginals(torch.zeros((2, 1), device="meta"),
                                  ((fe.ROT_X, 0, 1, 0),), 3)
    # a 1q op's second qubit is padding and is not checked
    fe.evolve_frame_marginals(theta, ((fe.ROT_X, 0, 1, 0),), 1)


def _merge_prone_plan(rng, nq, n_ops):
    """A random plan over cx, rz, rx, h and cz, in which cx(a, b) rz(b)
    cx(a, b) runs with other qubits' ops between them are common."""
    plan, slot = [], 0
    while len(plan) < n_ops:
        a, b = (int(x) for x in rng.choice(nq, 2, replace=False))
        pick = int(rng.integers(5))
        if pick < 2:               # a bond: cx, (other ops), rz, cx
            plan.append((fe.GATE_CX, a, b, -1))
            c = int(rng.integers(nq))
            if c not in (a, b):
                plan.append((fe.ROT_X, c, 0, slot))
                slot += 1
            plan.append((fe.ROT_Z, b, 0, slot))
            slot += 1
            plan.append((fe.GATE_CX, a, b, -1))
        elif pick == 2:
            plan.append((fe.ROT_X, a, 0, slot))
            slot += 1
        elif pick == 3:
            plan.append((fe.GATE_H, a, 0, -1))
        else:
            plan.append((fe.GATE_CZ, a, b, -1))
    return tuple(plan), slot


def _plan_case(name, rng):
    """(plan, n_rot, nq): the Ising template's own plan, or a random one."""
    if name.startswith("ising"):
        nq = int(name[5:])
        tpl = make_ising_template(nq, 2, "Z", 0.25, h=1.0)
        ct = tpl.bind_host(np.zeros(tpl.num_parameters, np.float32))
        plan, meta = tft.frame_plan(ct)
        return plan, len(meta), nq
    plan, n_rot = _merge_prone_plan(rng, 4, 60)
    return plan, n_rot, 4


@pytest.mark.parametrize("name", ["ising4", "ising5", "random"])
def test_fused_plan_matches_unfused_bit_for_bit(name, rng):
    """The kernel runs fuse_plan's merged plan: on the plain version it
    gives the unmerged plan's marginals bit for bit."""
    plan, n_rot, nq = _plan_case(name, rng)
    fused = fe.fuse_plan(plan)
    merged = sum(op[0] == fe.GATE_CX for op in plan) - sum(
        op[0] == fe.GATE_CX for op in fused)
    assert merged > 0 and len(fused) == len(plan) - merged
    assert sum(op[0] == fe.ROT_ZZ for op in fused) == merged // 2
    theta = torch.as_tensor(rng.uniform(-3, 3, size=(33, n_rot)),
                            dtype=torch.float32)
    want = fe.evolve_frame_marginals_reference(theta, plan, nq)
    got = fe.evolve_frame_marginals_reference(theta, fused, nq)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("name", ["ising4", "random"])
def test_fused_plan_matches_jax_interpret(name, rng):
    plan, n_rot, nq = _plan_case(name, rng)
    theta = rng.uniform(-3, 3, size=(5, n_rot)).astype(np.float32)
    got = fe.evolve_frame_marginals_reference(torch.as_tensor(theta),
                                              fe.fuse_plan(plan), nq)
    want = np.asarray(j_evolve(jnp.asarray(theta), plan, nq, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_fuse_plan_leaves_plans_without_a_run_unchanged(rng):
    for nq in (1, 2, 5, 10):
        plan, _ = fe.every_kind_plan(rng, nq, 148)
        assert fe.fuse_plan(plan) == plan
        plan, _ = fe.every_path_plan(rng, nq)
        assert fe.fuse_plan(plan) == plan
    cx = (fe.GATE_CX, 0, 1, -1)
    for near_miss in (
            (cx, (fe.ROT_Z, 0, 0, 0), cx),                 # rz on the control
            (cx, (fe.ROT_Z, 1, 0, 0), (fe.GATE_CX, 1, 0, -1)),
            (cx, (fe.ROT_Z, 1, 0, 0), (fe.GATE_CY, 0, 1, -1)),
            (cx, (fe.ROT_X, 0, 0, 0), (fe.ROT_Z, 1, 0, 1), cx),
            (cx, (fe.ROT_Z, 1, 0, 0), (fe.GATE_H, 1, 0, -1), cx),
            (cx, (fe.ROT_Z, 1, 0, 0), (fe.GATE_CZ, 2, 0, -1), cx),
            (cx, (fe.ROT_Z, 1, 0, 0)), ((fe.ROT_Z, 1, 0, 0), cx)):
        assert fe.fuse_plan(near_miss) == near_miss
    # ops on other qubits between the three do not stop the merge
    plan = (cx, (fe.GATE_CX, 2, 3, -1), (fe.ROT_Z, 1, 0, 0),
            (fe.ROT_Y, 2, 0, 1), cx)
    assert fe.fuse_plan(plan) == ((fe.GATE_CX, 2, 3, -1),
                                  (fe.ROT_ZZ, 0, 1, 0), (fe.ROT_Y, 2, 0, 1))


@pytest.mark.parametrize("nq", [1, 3, 6])
def test_every_path_plan_moves_every_qubit_with_every_kind(nq, rng):
    plan, n_rot = fe.every_path_plan(rng, nq)
    assert fe.check_plan(plan, nq, n_rot) == plan
    moved = {(op[0], op[2] if op[0] in (fe.GATE_CX, fe.GATE_CY) else op[1])
             for op in plan}
    kinds = ((fe.ROT_X, fe.ROT_Y, fe.GATE_H) if nq == 1 else
             (fe.ROT_X, fe.ROT_Y, fe.GATE_H, fe.GATE_CX, fe.GATE_CY,
              fe.GATE_SWAP))
    assert {(k, q) for k in kinds for q in range(nq)} <= moved
    if nq <= 3:
        theta = rng.uniform(-3, 3, size=(3, n_rot)).astype(np.float32)
        got = fe.evolve_frame_marginals(torch.as_tensor(theta), plan, nq)
        want = np.asarray(j_evolve(jnp.asarray(theta), plan, nq,
                                   interpret=True))
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
