"""Port vs JAX package: the host modules of the application layer.

QASM interchange, the native encoder library, the flagship model's entry,
the stage timer and trace, the job ledger and the rl/ngs stubs. All of
them but the entry and the trace are host code, held equal to the JAX
package's; the entry's forward is held within 1e-5 of the flax forward on
the same weights.
"""
import json

import numpy as np
import pytest

from mlqem_tpu.circuits.families import random_circuit as j_random_circuit
from mlqem_tpu.data.encoders import encode_data as j_encode_data
from mlqem_tpu.device.registry import get_device as j_get_device
from mlqem_tpu.transpile.qasm import from_qasm as j_from_qasm
from mlqem_tpu.transpile.qasm import to_qasm as j_to_qasm
from mlqem_tpu.utils import jobs as j_jobs
from mlqem_tpu.utils import native as j_native
from mlqem_tpu.utils.profiling import StageTimer as JStageTimer

from mlqem_tpu_torch import Circuit, IdealEstimator, PauliSum, get_device
from mlqem_tpu_torch.data.encoders import encode_data
from mlqem_tpu_torch.ngs import NGSAgent, NGSEnvironment, NGSModel
from mlqem_tpu_torch.rl import ActionResult, Agent, Environment
from mlqem_tpu_torch.transpile.qasm import from_qasm, to_qasm
from mlqem_tpu_torch.utils import build, native
from mlqem_tpu_torch.utils.jobs import JobLedger, run_with_resubmission
from mlqem_tpu_torch.utils.profiling import StageTimer, trace

from port_fixtures import one_torch_thread  # noqa: F401

DEV, J_DEV = get_device("fake_lima"), j_get_device("fake_lima")


def _jax_circuits(n, seed=0, measure=False):
    """JAX circuits as the JAX native test draws them, and their port
    copies."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        qc = j_random_circuit(4, int(rng.integers(2, 6)),
                              seed=int(rng.integers(2 ** 31)))
        if measure:
            qc.measure_all()
        out.append(qc)
    return out, [Circuit.from_dict(c.to_dict()) for c in out]


# ---------------------------------------------------------------------------
# QASM
# ---------------------------------------------------------------------------
def test_qasm_text_and_round_trip_match_jax():
    j_circs, circs = _jax_circuits(6, seed=2, measure=True)
    extra = Circuit(3).h(0).cx(0, 1).rz(-0.25, 2).barrier().u3(
        0.1, 0.2, 0.3, 1).cp(0.7, 1, 2).swap(0, 2).ecr(1, 0)
    circs.append(extra)
    j_circs.append(type(j_circs[0]).from_dict(extra.to_dict()))
    for qc, jqc in zip(circs, j_circs):
        text = to_qasm(qc)
        assert text == j_to_qasm(jqc)
        back = from_qasm(text)
        assert back.to_dict() == j_from_qasm(text).to_dict()
        assert back.count_ops() == qc.count_ops()
        assert to_qasm(back) == text


def test_qasm_pi_expressions_match_jax():
    text = """OPENQASM 2.0;
include "qelib1.inc";
qreg q[2];
creg meas[2];
rz(pi/2) q[0];
sx q[0];
rz(-pi/4) q[1];
u3(2*pi/3,-pi/2,2.5e-1) q[1];
cx q[0],q[1];  // a comment
measure q[0] -> meas[0];
measure q[1] -> meas[1];
"""
    qc = from_qasm(text)
    assert qc.count_ops() == {"rz": 2, "sx": 1, "u3": 1, "cx": 1,
                              "measure": 2}
    assert qc.to_dict() == j_from_qasm(text).to_dict()
    assert qc.ops[0].params[0] == np.pi / 2


@pytest.mark.parametrize("stmt", ["rz(__import__) q[0];", "rz(pi pi) q[0];",
                                  "rz(PI) q[0];", "rz(1e) q[0];",
                                  "foo q[0];", "rz(0.1,) q[0];"])
def test_qasm_rejects_what_it_cannot_read(stmt):
    text = f"OPENQASM 2.0;\nqreg q[1];\n{stmt}"
    with pytest.raises(Exception):
        j_from_qasm(text)
    with pytest.raises(ValueError):
        from_qasm(text)


def test_qasm_refusals():
    with pytest.raises(ValueError, match="qreg"):
        from_qasm("OPENQASM 2.0;\nh q[0];")
    with pytest.raises(ValueError, match="no qreg"):
        from_qasm("OPENQASM 2.0;")
    with pytest.raises(ValueError, match="no QASM"):
        to_qasm(Circuit(2).ryy(0.3, 0, 1))


# ---------------------------------------------------------------------------
# native encoders
# ---------------------------------------------------------------------------
def test_native_library_builds_into_the_build_dir():
    lib = native.load_native()
    assert lib is not None, "a host compiler is expected in this image"
    assert lib._name.startswith(build.BUILD_DIR)


def test_native_batches_match_reference_and_jax():
    j_circs, circs = _jax_circuits(20)
    kinds = sorted(DEV.properties()["gates_set"])
    kind_index = {g: i for i, g in enumerate(kinds)}
    flat = native.flatten_circuits(circs, kind_index)
    j_flat = j_native.flatten_circuits(j_circs, kind_index)
    for key in ("kinds", "qubits", "params", "is_rot", "offsets"):
        np.testing.assert_array_equal(flat[key], j_flat[key])
    counts = native.count_gates_batch(flat, len(kinds))
    hist = native.angle_hist_batch(flat, 40)
    edges = native.wire_edges_batch(flat)
    np.testing.assert_array_equal(
        counts, native.count_gates_batch_reference(flat, len(kinds)))
    np.testing.assert_array_equal(
        counts, j_native.count_gates_batch(j_flat, len(kinds)))
    np.testing.assert_array_equal(
        hist, native.angle_hist_batch_reference(flat, 40))
    np.testing.assert_array_equal(hist, j_native.angle_hist_batch(j_flat, 40))
    j_edges = j_native.wire_edges_batch(j_flat)
    ref_edges = native.wire_edges_batch_reference(flat)
    assert len(edges) == len(ref_edges) == len(j_edges) == 20
    for a, b, c in zip(edges, ref_edges, j_edges):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_fast_encode_data_matches_encoders_and_jax():
    j_circs, circs = _jax_circuits(15, seed=3)
    props = DEV.properties()
    rng = np.random.default_rng(0)
    ideal = rng.uniform(-1, 1, (15, 4)).tolist()
    noisy = rng.uniform(-1, 1, (15, 4)).tolist()
    X, y = native.fast_encode_data(circs, props, ideal, noisy, 4)
    X_ref, y_ref = encode_data(circs, props, ideal, noisy, 4)
    X_j, y_j = j_native.fast_encode_data(j_circs, J_DEV.properties(), ideal,
                                         noisy, 4)
    np.testing.assert_allclose(X, X_ref, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(X, X_j)
    np.testing.assert_array_equal(y, y_ref)
    np.testing.assert_array_equal(y, y_j)
    # with measurement bases, as the learning processor encodes
    X_b, _ = native.fast_encode_data(circs[:1], props, [[0.0]], [[0.3]], 1,
                                     meas_bases=[[1.0, 0.0, 0.0, 1.0]])
    X_bj, _ = j_encode_data(j_circs[:1], J_DEV.properties(), [[0.0]],
                            [[0.3]], 1, meas_bases=[[1.0, 0.0, 0.0, 1.0]])
    np.testing.assert_allclose(X_b, X_bj, atol=1e-6, rtol=0)


def test_native_falls_back_without_a_compiler(monkeypatch, tmp_path):
    """Without a host compiler (and nothing built) every entry point runs
    its numpy version; a compiler that fails raises."""
    j_circs, circs = _jax_circuits(6, seed=4)
    kind_index = {g: i for i, g in enumerate(
        sorted(DEV.properties()["gates_set"]))}
    flat = native.flatten_circuits(circs, kind_index)
    want = (native.count_gates_batch(flat, len(kind_index)),
            native.angle_hist_batch(flat, 40))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "find_host_compiler", lambda: None)
    native.load_native.cache_clear()
    try:
        assert native.load_native() is None
        got = (native.count_gates_batch(flat, len(kind_index)),
               native.angle_hist_batch(flat, 40))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        monkeypatch.setattr(build, "find_host_compiler", lambda: "false")
        native.load_native.cache_clear()
        with pytest.raises(RuntimeError, match="failed"):
            native.load_native()
    finally:
        native.load_native.cache_clear()


# ---------------------------------------------------------------------------
# the flagship entry
# ---------------------------------------------------------------------------
def _flax_entry():
    """``__graft_entry__.entry``'s model, inputs and forward, with the
    flax init and forward under ``jax.jit`` (its eager init takes ~20 s on
    the CPU)."""
    import jax
    import jax.numpy as jnp

    from mlqem_tpu.models.gnn import ExpValCircuitGraphModel3 as JGNN3

    B, N, F, K = 8, 32, 22, 4
    model = JGNN3(hidden_channels=15, exp_value_size=K)
    key = jax.random.PRNGKey(0)
    rng = np.random.default_rng(0)
    noisy = jnp.asarray(rng.uniform(-1, 1, (B, K)), jnp.float32)
    observable = jnp.asarray(rng.normal(size=(B, 1, 17)), jnp.float32)
    depth = jnp.asarray(rng.uniform(1, 9, (B,)), jnp.float32)
    x = jnp.asarray(rng.normal(size=(B, N, F)), jnp.float32)
    adj = np.zeros((B, N, N), np.float32)
    adj[:, np.arange(1, N), np.arange(N - 1)] = 1.0
    node_mask = jnp.ones((B, N), bool)
    inputs = (noisy, observable, depth, x, jnp.asarray(adj), node_mask)
    variables = jax.jit(lambda *a: model.init(
        {"params": key, "dropout": key}, *a, train=False))(*inputs)
    out = jax.jit(lambda v, *a: model.apply(v, *a, train=False))(
        variables, *inputs)
    return variables, inputs, np.asarray(out)


def test_entry_forward_matches_flax():
    from mlqem_tpu_torch.convert import state_dict_from_flax
    from mlqem_tpu_torch.entry import entry

    variables, j_inputs, want = _flax_entry()
    fn, args = entry(device="cpu")
    for a, b in zip(args[1:], j_inputs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    state = state_dict_from_flax(variables)
    assert set(state) == set(args[0])
    got = fn(state, *args[1:]).numpy()
    assert got.shape == want.shape == (8, 4)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    own = fn(*args)
    assert own.shape == (8, 4) and bool(own.isfinite().all())


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------
def test_stage_timer_report_and_throughput_match_jax():
    t = StageTimer()
    with t.stage("encode"):
        sum(range(1000))
    with t.stage("encode"):
        sum(range(1000))
    assert t.counts["encode"] == 2
    assert "encode" in t.report()
    assert t.throughput("encode", 100) > 0
    assert t.throughput("missing", 100) == 0.0
    jt = JStageTimer()
    for timer in (t, jt):
        timer.totals = {"a": 0.25, "b": 1.5}
        timer.counts = {"a": 3, "b": 2}
    assert t.report() == jt.report()
    assert t.throughput("b", 30) == jt.throughput("b", 30)


def test_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with trace(str(tmp_path / "prof")) as prof:
        torch.ones(64).cumsum(0)
    assert prof is not None
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("cumsum" in str(e.get("name", "")) for e in events)


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------
def test_job_ledger_roundtrip_readable_by_both_packages(tmp_path):
    path = str(tmp_path / "jobs.json")
    ledger = JobLedger(path)
    est = IdealEstimator(device="cpu")
    qc = Circuit(2).h(0).cx(0, 1)
    run_with_resubmission(ledger, lambda key: est.run(qc, PauliSum("ZZ")),
                          ["a", "b"])
    assert ledger.records["a"].status == "DONE"
    assert abs(ledger.records["a"].values[0] - 1.0) < 1e-6
    assert ledger.records["a"].job_id
    # resume from disk: nothing resubmitted, state preserved
    ledger2 = JobLedger(path)
    assert ledger2.records["b"].status == "DONE"
    assert ledger2.pending_or_failed() == []
    calls = []
    run_with_resubmission(ledger2, calls.append, ["a", "b"])
    assert calls == []
    # the JAX package reads the port's ledger, and the port the JAX one's
    j_ledger = j_jobs.JobLedger(path)
    assert {k: vars(v) for k, v in j_ledger.records.items()} == {
        k: vars(v) for k, v in ledger2.records.items()}
    j_ledger.record("c").status = "FAILED"
    j_ledger.save()
    assert JobLedger(path).pending_or_failed() == ["c"]


def test_job_resubmission_on_failure(tmp_path):
    ledger = JobLedger(str(tmp_path / "jobs.json"))
    attempts = {"n": 0}
    est = IdealEstimator(device="cpu")
    qc = Circuit(1).x(0)

    def flaky_submit(key):
        attempts["n"] += 1
        if attempts["n"] < 3:
            raise RuntimeError("transient backend failure")
        return est.run(qc, PauliSum("Z"))

    run_with_resubmission(ledger, flaky_submit, ["job1"], max_attempts=5)
    rec = ledger.records["job1"]
    assert rec.status == "DONE"
    assert rec.attempts == 3
    assert abs(rec.values[0] + 1.0) < 1e-6


def test_job_permanent_failure(tmp_path):
    ledger = JobLedger(str(tmp_path / "jobs.json"))

    def always_fails(key):
        raise ValueError("no backend")

    run_with_resubmission(ledger, always_fails, ["x"], max_attempts=2)
    rec = ledger.records["x"]
    assert rec.status == "FAILED"
    assert rec.attempts == 2
    assert "no backend" in rec.error


# ---------------------------------------------------------------------------
# rl / ngs
# ---------------------------------------------------------------------------
def test_rl_ngs_scaffolding():
    env = NGSEnvironment(circuit="c", noise_model="n")
    assert env.get_state() == ("c", "n")
    agent = NGSAgent(env)
    assert isinstance(agent, Agent) and isinstance(env, Environment)
    for call in (agent.select_action, agent.perform_action):
        with pytest.raises(NotImplementedError):
            call(None)
    with pytest.raises(NotImplementedError):
        agent.optimize_model()
    r = ActionResult(state=1, reward=0.5)
    assert (r.reward, r.done, r.info) == (0.5, False, None)
    assert NGSModel is not None
    with pytest.raises(NotImplementedError):
        Environment().get_state()
