"""K2's schedule above 10 qubits on the CPU: ``frame_schedule`` and its
plain emulation ``emulate_schedule`` (relayouts and passes as permutations
of the index bits, each op at its positions) against the plain version of
the kernel, the schedule's invariants (what the CUDA kernel relies on),
its pinned segment and pass counts, the program the kernel reads, and the
plain version against the JAX kernel in interpret mode at 11 and 12
qubits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlqem_tpu.ops.pallas.frame_evolve import \
    evolve_frame_marginals as j_evolve

from mlqem_tpu_torch.ops.frame_trajectory import frame_plan
from mlqem_tpu_torch.ops.kernels import frame_evolve as fe
from mlqem_tpu_torch.parallel.datagen import make_ising_template

from port_fixtures import one_torch_thread  # noqa: F401

WIDTHS = (11, 12, 13, 14, 15, 16, 20)
PLANS = ("every_kind", "every_path", "ising")


def _plan(name, nq, rng):
    """(checked plan, angle slots) of the named plan at nq."""
    if name == "every_kind":
        plan, n_rot = fe.every_kind_plan(rng, nq, 48 if nq >= 20 else 148)
    elif name == "every_path":
        plan, n_rot = fe.every_path_plan(rng, nq)
    else:                                   # the Ising template, 2 steps
        tpl = make_ising_template(nq, 2, "Z", 0.25, h=1.0)
        plan, meta = frame_plan(tpl.bind_host(
            np.zeros(tpl.num_parameters, np.float32)))
        n_rot = len(meta)
    return fe.check_plan(plan, nq, n_rot), n_rot


@pytest.mark.parametrize("name", PLANS)
@pytest.mark.parametrize("nq", WIDTHS)
def test_schedule_emulation_matches_plain_version(nq, name):
    rng = np.random.default_rng(nq)
    plan, n_rot = _plan(name, nq, rng)
    rows = 1 if nq >= 20 else 3
    theta = torch.as_tensor(rng.uniform(-3, 3, size=(rows, n_rot)),
                            dtype=torch.float32)
    got = fe.emulate_schedule(theta, fe.frame_schedule(plan, nq))
    want = fe.evolve_frame_marginals_reference(theta, plan, nq)
    assert got.shape == (rows, nq)
    assert (got - want).abs().max().item() <= 1e-6


@pytest.mark.parametrize("nq", WIDTHS + (18, 30))
def test_schedule_keeps_its_invariants(nq):
    """Every op that moves a bit finds it at a register or lane position;
    no swap reaches the kernel; relayouts trade register positions for
    warp positions only (the lanes stay); above 14 qubits each pass's
    storage map is a permutation with storage bits 0-4 on the lanes and
    the registers on chip; the qubit maps are permutations."""
    rng = np.random.default_rng(100 + nq)
    chip = min(nq, fe.MAX_SMEM_NQ)
    for name in PLANS:
        plan, _ = _plan(name, nq, rng)
        sched = fe.frame_schedule(plan, nq)
        assert sched.nq == nq
        assert len(sched.passes) == 1 or nq > fe.MAX_SMEM_NQ
        n_ops = 0
        for pas in sched.passes:
            assert sorted(pas.qubit_at) == list(range(nq))
            assert sorted(pas.store) == list(range(nq))
            if nq > fe.MAX_SMEM_NQ:
                assert pas.store[5:10] == (0, 1, 2, 3, 4)
                assert all(pas.store[p] >= 5 for p in range(5))
            for op in pas.ops:
                kind, a, b, _ = op
                assert kind != fe.GATE_SWAP
                if kind == fe.RELAYOUT:
                    src = fe.unpack_relayout(op)
                    assert sorted(src) == list(range(fe.MAX_SMEM_NQ))
                    moved = {p for p in range(fe.MAX_SMEM_NQ) if src[p] != p}
                    assert moved <= set(range(5)) | set(range(10, chip))
                    assert all((p < 5) != (src[p] < 5) for p in moved)
                    continue
                n_ops += 1
                assert 0 <= a < nq
                if kind in fe.TWO_QUBIT_KINDS:
                    assert 0 <= b < nq and a != b
                if kind in fe.MOVING_KINDS:
                    target = b if kind in (fe.GATE_CX, fe.GATE_CY) else a
                    assert target < fe.NEAR
        fused = fe.fuse_plan(plan)
        assert n_ops == sum(op[0] != fe.GATE_SWAP for op in fused)


@pytest.mark.parametrize("nq,passes,relayouts", [
    (11, 1, 2), (14, 1, 3), (16, 3, 2), (20, 4, 3)])
def test_ising_schedule_counts_are_pinned(nq, passes, relayouts):
    """The Ising template at 2 steps: ~1.5 relayouts a Trotter step on
    chip; above 14 qubits each step brings the 9 non-lane qubits on chip
    at least once (16 qubits: 22 loads of 9 → 3 passes)."""
    plan, _ = _plan("ising", nq, np.random.default_rng(0))
    sched = fe.frame_schedule(plan, nq)
    assert (len(sched.passes), sched.relayouts) == (passes, relayouts)


def test_program_holds_the_schedule():
    """The records the kernel reads: each pass's storage and end-qubit
    maps a byte a position, then its ops; the pass table points at them
    and names the angle slots the pass reads."""
    rng = np.random.default_rng(3)
    for nq in (12, 17):
        plan, n_rot = _plan("every_kind", nq, rng)
        sched = fe.frame_schedule(plan, nq)
        records, table = fe.program(plan, nq)
        assert records.dtype == table.dtype == np.int32
        assert table.shape == (len(sched.passes), 4)
        for pas, (first, n_ops, slot_lo, n_slots) in zip(sched.passes,
                                                         table.tolist()):
            maps = records[first:first + 4].reshape(-1).view(np.uint8)
            assert tuple(maps[:nq]) == pas.store
            assert tuple(maps[32:32 + nq]) == pas.qubit_at
            ops = records[first + 4:first + 4 + n_ops]
            assert [tuple(op) for op in ops.tolist()] == list(pas.ops)
            slots = [op[3] for op in pas.ops if op[0] in fe.ROTATION_KINDS]
            assert (slot_lo, n_slots) == ((min(slots),
                                           max(slots) - min(slots) + 1)
                                          if slots else (0, 0))
        assert max(fe._smem_bytes(nq, plan, n_rot), 0) <= fe._MAX_SMEM_BYTES


def test_relayout_packing_round_trips():
    src = tuple(np.random.default_rng(1).permutation(fe.MAX_SMEM_NQ))
    op = fe.pack_relayout(src)
    assert op[0] == fe.RELAYOUT and all(0 <= x < 2 ** 31 for x in op)
    assert fe.unpack_relayout(op) == src


def test_scratch_slots():
    assert fe.scratch_slots(14, 10_000) == 0
    assert fe.scratch_slots(15, 3) == 3
    assert fe.scratch_slots(20, 10_000) == (1 << 30) // (8 << 20)
    assert fe.scratch_slots(30, 5) == 1


def test_schedule_refuses_the_warp_widths():
    with pytest.raises(ValueError, match="nq"):
        fe.frame_schedule(((fe.GATE_H, 0, 0, -1),), 10)


_JAX_PLAN_OPS = 24
_jax_evolve = jax.jit(lambda theta, plan, nq: j_evolve(
    theta, plan, nq, interpret=True), static_argnums=(1, 2))


@pytest.mark.parametrize("nq", [11, 12])
def test_plain_version_matches_jax_interpret_above_the_warp_width(nq):
    rng = np.random.default_rng(nq + 7)
    plan, n_rot = fe.every_kind_plan(rng, nq, _JAX_PLAN_OPS)
    theta = rng.uniform(-3, 3, size=(3, n_rot)).astype(np.float32)
    got = fe.evolve_frame_marginals(torch.as_tensor(theta), plan, nq)
    want = np.asarray(_jax_evolve(jnp.asarray(theta), plan, nq))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
