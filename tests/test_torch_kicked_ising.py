"""Port vs JAX package: the kicked-Ising label generator as a whole.

Both engines take the same noise draws, made with numpy: the JAX engine
imports ``sample_small_categorical`` from ``mlqem_tpu.ops.sampling`` when
it runs, and the port's engine calls ``mlqem_tpu_torch.ops.sampling``'s, so
patching both module attributes hands them the same draws. Everything
after the draws is deterministic (with ``shots=None``) and is held to
float rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlqem_tpu.ops.sampling as j_sampling
from mlqem_tpu.device.registry import configurable_device as j_configurable
from mlqem_tpu.ops.kicked_ising import KickedIsingEngine as JEngine

import mlqem_tpu_torch.ops.sampling as t_sampling
from mlqem_tpu_torch import KickedIsingEngine, configurable_device
from mlqem_tpu_torch.convert import engine_tables_from_numpy

from lightcone_windows import window_bonds


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs six workers on a
    few cores, and torch's thread pool, oversubscribed, makes these small
    ops tens of times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draws(rng, steps, rows, nb):
    """Every one of the 16 Paulis, uniformly: a hard test of propagation."""
    return rng.integers(0, 16, size=(steps, rows, nb, 2)).astype(np.int32)


def _share_draws(monkeypatch, draws):
    def j_sample(key, probs, shape):
        assert tuple(shape) == draws.shape
        return jnp.asarray(draws)

    def t_sample(probs, shape, generator):
        assert tuple(shape) == draws.shape
        return torch.as_tensor(draws)

    monkeypatch.setattr(j_sampling, "sample_small_categorical", j_sample)
    monkeypatch.setattr(t_sampling, "sample_small_categorical", t_sample)


@pytest.mark.parametrize("nq, window", [(5, None), (10, None),
                                        (13, (6, 13, 30))],
                         ids=["5", "10", "w13-start7"])
def test_frame_signs_identical(nq, window, rng, monkeypatch):
    """The port's frame pass (the plain version, on the CPU) equals the JAX
    engine's ``_frame_signs`` on shared draws: at the engine's own bonds,
    and at a light-cone window's bond order (both engines' bonds replaced
    by the window's)."""
    B, T, S = 4, 8, 3
    jeng = JEngine(j_configurable(nq, seed=0), nq=nq, steps=S, n_traj=T,
                   shots=None, use_pallas=False)
    eng = KickedIsingEngine(configurable_device(nq, seed=0), nq=nq,
                            steps=S, device="cpu", n_traj=T, shots=None)
    if window is not None:
        w, bonds = window_bonds(*window)
        assert w == nq and bonds[0] == (1, 2)
        jeng.even_bonds, jeng.odd_bonds = list(bonds), []
        eng.bonds = list(bonds)
    draws = _draws(rng, S, B * T, len(eng.bonds))
    _share_draws(monkeypatch, draws)
    j_kick, j_bond, j_flip = (np.asarray(a) for a in
                              jeng._frame_signs(jax.random.PRNGKey(0), B))
    kick, bond, flip = eng.frame_signs(eng.sample_draws(B * T, None))
    # port layout [rows, S·k] vs JAX [S, rows, k]
    np.testing.assert_array_equal(
        kick.numpy(), np.swapaxes(j_kick, 0, 1).reshape(B * T, S * nq))
    np.testing.assert_array_equal(
        bond.numpy(), np.swapaxes(j_bond, 0, 1).reshape(B * T, -1))
    np.testing.assert_array_equal(flip.numpy(), j_flip)
    assert (kick == -1).any() and (bond == -1).any() and (flip == -1).any()


def _bad_frame_args():
    """(draws, bonds, nq, error) the frame pass refuses, each on its own."""
    bonds = [(0, 1), (2, 3), (1, 2)]
    good = torch.zeros((2, 5, 3, 2), dtype=torch.int32)
    return {
        "float-draws": (good.float(), bonds, 4, TypeError),
        "int64-draws": (good.long(), bonds, 4, TypeError),
        "non-contiguous": (torch.zeros((5, 2, 3, 2), dtype=torch.int32
                                       ).transpose(0, 1), bonds, 4,
                           ValueError),
        "three-axes": (good.reshape(2, 5, 6), bonds, 4, ValueError),
        "bond-count": (good, bonds[:2], 4, ValueError),
        "last-axis": (torch.zeros((2, 5, 3, 3), dtype=torch.int32), bonds,
                      4, ValueError),
        "nq-above-31": (torch.zeros((1, 2, 1, 2), dtype=torch.int32),
                        [(30, 31)], 32, ValueError),
        "bond-off-chain": (good, [(0, 1), (2, 4), (1, 2)], 4, ValueError),
        "negative-qubit": (good, [(0, 1), (-1, 0), (1, 2)], 4, ValueError),
    }


@pytest.mark.parametrize("case", list(_bad_frame_args()))
def test_frame_pass_checks_its_arguments_on_the_cpu(case, monkeypatch):
    """The wrapper refuses what the kernel does not take before it looks
    at the device, so these CPU tensors reach neither kernel nor plain
    version."""
    from mlqem_tpu_torch.ops.kernels import frames as kfr

    def refuse(*a, **kw):
        raise AssertionError("the frame pass ran on arguments it refuses")

    monkeypatch.setattr(kfr, "_launch", refuse)
    monkeypatch.setattr(kfr, "propagate_frames_reference", refuse)
    draws, bonds, nq, error = _bad_frame_args()[case]
    with pytest.raises(error):
        kfr.propagate_frames(draws, bonds, nq)


@pytest.mark.parametrize("use_kernel", [None, False])
def test_frame_signs_take_the_plain_version_on_the_cpu(use_kernel, rng,
                                                       monkeypatch):
    """On the CPU the engine's frame pass is the plain version, through the
    wrapper by default and directly with use_kernel=False; the kernel's
    entry is never reached and no launch is counted."""
    from mlqem_tpu_torch.ops.kernels import frames as kfr

    def refuse(*a, **kw):
        raise AssertionError("the kernel entry was reached")

    wrapper = kfr.propagate_frames
    monkeypatch.setattr(kfr, "_launch", refuse)
    monkeypatch.setattr(kfr, "load_library", refuse)
    if use_kernel is False:
        monkeypatch.setattr(kfr, "propagate_frames", refuse)
    nq, S, rows = 6, 3, 40
    eng = KickedIsingEngine(configurable_device(nq, seed=0), nq=nq, steps=S,
                            device="cpu", shots=None, use_kernel=use_kernel)
    draws = torch.as_tensor(_draws(rng, S, rows, nq - 1))
    before = wrapper.launches
    kick, bond, flip = eng.frame_signs(draws)
    want_kick, want_bond, x_after = kfr.propagate_frames_reference(
        draws, eng.bonds, nq)
    assert torch.equal(kick, want_kick.reshape(rows, S * nq))
    assert torch.equal(bond, want_bond.reshape(rows, -1))
    qs = torch.arange(nq, dtype=torch.int32)
    assert torch.equal(flip, (1 - 2 * ((x_after[-1][:, None] >> qs) & 1)
                              ).float())
    assert wrapper.launches == before


@pytest.mark.parametrize("readout", [True, False])
@pytest.mark.parametrize("noise_scale", [1, 3])
@pytest.mark.parametrize("nq", [6, 10])
def test_labels_match_jax_without_shots(nq, noise_scale, readout, rng,
                                        monkeypatch):
    B, T, S = 4, 8, 4
    J = rng.uniform(0.05, 0.6, size=B).astype(np.float32)
    kw = dict(nq=nq, steps=S, dt=0.25, n_traj=T, shots=None,
              readout=readout, noise_scale=noise_scale)
    jeng = JEngine(j_configurable(nq, seed=0), use_pallas=False, **kw)
    eng = KickedIsingEngine(configurable_device(nq, seed=0), device="cpu",
                            **kw)
    # the port builds the same tables itself; assert it, then force them
    np.testing.assert_allclose(eng.tables.bond_probs.numpy(),
                               jeng._bond_probs, atol=1e-7, rtol=0)
    assert (eng.tables.confusion is None) == (jeng._confusion is None)
    eng.tables = engine_tables_from_numpy(jeng._bond_probs, jeng._confusion,
                                          device="cpu")
    # mostly identity (no error), plus a share of uniform Paulis so every
    # frame path is exercised
    draws = _draws(rng, S, B * T, nq - 1)
    keep = rng.random(draws.shape) < 0.9
    draws[keep] = 0
    _share_draws(monkeypatch, draws)
    j_ideal, j_noisy = jeng.generate(J, seed=0)
    ideal, noisy = eng.generate(J, seed=0)
    assert ideal.shape == noisy.shape == (B, nq)
    np.testing.assert_allclose(ideal, j_ideal, atol=1e-5, rtol=0)
    np.testing.assert_allclose(noisy, j_noisy, atol=1e-5, rtol=0)


def test_shot_noise_within_five_sigma():
    nq, B, T, shots = 10, 4, 8, 10000
    J = np.random.default_rng(5).uniform(0.05, 0.6, size=B)
    kw = dict(nq=nq, steps=4, device="cpu", n_traj=T)
    exact = KickedIsingEngine(configurable_device(nq, seed=0), shots=None,
                              **kw)
    sampled = KickedIsingEngine(configurable_device(nq, seed=0),
                                shots=shots, **kw)
    # same seed → same noise draws, so only the binomial shots differ
    ideal0, noisy0 = exact.generate(J, seed=11)
    ideal1, noisy1 = sampled.generate(J, seed=11)
    np.testing.assert_array_equal(ideal0, ideal1)
    n = shots // T                      # 1250 shots per trajectory
    sigma = np.sqrt(1.0 / (n * T))      # var(mean) ≤ Σ 4p(1−p)/n / T²
    assert np.all(np.abs(noisy1 - noisy0) <= 5 * sigma)
    assert not np.array_equal(noisy1, noisy0)


def test_noisy_labels_match_jax_statistically():
    """Independent streams (torch Philox vs JAX threefry): the trajectory
    means agree within their sampling spread."""
    nq, B, T = 6, 2, 2000
    J = np.array([0.2, 0.5], np.float32)
    kw = dict(nq=nq, steps=4, n_traj=T, shots=None)
    j_ideal, j_noisy = JEngine(j_configurable(nq, seed=0), use_pallas=False,
                               **kw).generate(J, seed=0)
    ideal, noisy = KickedIsingEngine(configurable_device(nq, seed=0),
                                     device="cpu", **kw).generate(J, seed=0)
    np.testing.assert_allclose(ideal, j_ideal, atol=1e-5, rtol=0)
    assert np.all(np.abs(noisy - j_noisy) <= 5 * np.sqrt(2.0 / T))
    assert np.abs(noisy - ideal).max() > 1e-3     # the noise does act


def test_use_kernel_needs_cuda():
    with pytest.raises(ValueError, match="CUDA"):
        KickedIsingEngine(configurable_device(4, seed=0), nq=4, steps=1,
                          device="cpu", use_kernel=True)


def test_engine_tables_for_a_custom_noise_model():
    from mlqem_tpu.device.noise import NoiseModel as JNoiseModel
    from mlqem_tpu.ops.channels import depolarizing_channel as j_depol

    from mlqem_tpu_torch import NoiseModel
    from mlqem_tpu_torch.ops.channels import depolarizing_channel

    nq = 5
    nm = NoiseModel(nq).add_all_qubit_quantum_error(
        depolarizing_channel(0.03, 2), "cx")
    nm.add_quantum_error(depolarizing_channel(0.1, 2), "cx", (3, 2))
    jnm = JNoiseModel(nq).add_all_qubit_quantum_error(j_depol(0.03, 2), "cx")
    jnm.add_quantum_error(j_depol(0.1, 2), "cx", (3, 2))
    kw = dict(nq=nq, steps=2, n_traj=4, noise_scale=2)
    eng = KickedIsingEngine(configurable_device(nq), device="cpu",
                            noise_model=nm, **kw)
    jeng = JEngine(j_configurable(nq), noise_model=jnm, use_pallas=False,
                   **kw)
    np.testing.assert_allclose(eng.tables.bond_probs.numpy(),
                               jeng._bond_probs, atol=1e-7, rtol=0)
    assert eng.tables.confusion is None and jeng._confusion is None


def test_engine_refuses_noise_on_rotations():
    from mlqem_tpu_torch import NoiseModel
    from mlqem_tpu_torch.ops.channels import depolarizing_channel

    nm = NoiseModel(4).add_all_qubit_quantum_error(
        depolarizing_channel(0.01, 1), "rx")
    with pytest.raises(ValueError, match="CX\\+readout noise only"):
        KickedIsingEngine(configurable_device(4), nq=4, steps=1,
                          device="cpu", noise_model=nm)


@pytest.mark.parametrize("nq", [12, 14, 15])
def test_engine_above_k1_width_matches_jax(nq, rng, monkeypatch):
    """At 12 qubits the evolution is K1's plain version; at 14 and 15 it is
    ``kicked_steps`` through K3's (the widths the card could not run
    before: K1 takes nq ≤ 13)."""
    B, T, S = 2, 3, 2
    J = rng.uniform(0.05, 0.6, size=B).astype(np.float32)
    kw = dict(nq=nq, steps=S, dt=0.25, n_traj=T, shots=None)
    jeng = JEngine(j_configurable(nq, seed=0), use_pallas=False, **kw)
    eng = KickedIsingEngine(configurable_device(nq, seed=0), device="cpu",
                            use_kernel=False, **kw)
    draws = _draws(rng, S, B * T, nq - 1)
    draws[rng.random(draws.shape) < 0.8] = 0
    _share_draws(monkeypatch, draws)
    j_ideal, j_noisy = jeng.generate(J, seed=0)
    ideal, noisy = eng.generate(J, seed=0)
    np.testing.assert_allclose(ideal, j_ideal, atol=1e-5, rtol=0)
    np.testing.assert_allclose(noisy, j_noisy, atol=1e-5, rtol=0)
    assert np.abs(noisy - ideal).max() > 1e-3


@pytest.mark.parametrize("nq, route", [(13, "evolve_fused"),
                                       (14, "fused_trotter_step"),
                                       (15, "fused_trotter_step")])
def test_engine_picks_the_kernel_for_its_width(nq, route, monkeypatch):
    """The engine calls K1's wrapper up to 13 qubits and K3's, one call a
    step, from 14 (on the CPU each wrapper runs its plain version, so the
    calls are counted here in place of the card's launches);
    use_kernel=False calls none of them."""
    import mlqem_tpu_torch.ops.kernels.evolve as kev
    import mlqem_tpu_torch.ops.kernels.fused_step as kfs
    import mlqem_tpu_torch.ops.kernels.wht as kwht

    calls = {}
    for mod, name in ((kev, "evolve_fused"), (kfs, "fused_trotter_step"),
                      (kwht, "wht_planes")):
        def counted(*a, _fn=getattr(mod, name), _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    S = 2
    kw = dict(nq=nq, steps=S, n_traj=2, shots=None, device="cpu")
    J = np.array([0.3], np.float32)
    want = {"evolve_fused": 2, "fused_trotter_step": 2 * S}[route]
    got = KickedIsingEngine(configurable_device(nq, seed=0), **kw
                            ).generate(J, seed=0)
    assert calls == {route: want}
    calls.clear()
    plain = KickedIsingEngine(configurable_device(nq, seed=0),
                              use_kernel=False, **kw).generate(J, seed=0)
    assert calls == {}
    for a, b in zip(got, plain):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_zne_sweep_at_12_qubits():
    """``zne_sweep_ising`` (the 20-qubit baseline's workflow) at 12 qubits,
    as the JAX package's test runs it: extrapolation beats the noisy
    values."""
    from mlqem_tpu_torch import zne_sweep_ising

    out = zne_sweep_ising(configurable_device(12, seed=0), nq=12, steps=2,
                          J_values=np.linspace(0.1, 0.5, 4), n_traj=256,
                          shots=None, seed=0, device="cpu")
    assert out["zne"].shape == out["ideal"].shape == (4, 12)
    assert set(out["measured"]) == {1, 3}
    assert out["rmse_zne"] < out["rmse_noisy"]


def _asymmetric_confusion(rng, nq):
    """Per-qubit assignment matrices M[meas, true] with p(1|0) ≠ p(0|1)."""
    p10 = rng.uniform(0.005, 0.05, nq)
    p01 = rng.uniform(0.06, 0.15, nq)
    return np.array([[1 - p10, p01], [p10, 1 - p01]]).transpose(2, 0, 1)


def _engine_with_confusion(nq, conf, n_traj):
    eng = KickedIsingEngine(configurable_device(nq, seed=0), nq=nq, steps=1,
                            device="cpu", n_traj=n_traj, shots=None)
    eng.tables = engine_tables_from_numpy(eng.tables.bond_probs.numpy(),
                                          conf, device="cpu")
    return eng


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("nq", [2, 5, 10, 14])
def test_trajectory_z_equals_confusion_of_the_distribution(nq, scaled, rng):
    """The marginal readout (a·⟨Z⟩ + b·T, then the flip) against the
    computation it replaces: the confusion applied to the whole
    distribution, then ⟨Z⟩, then the flip. Scaled rows (totals in
    [0.5, 2]) exercise the total's column."""
    from mlqem_tpu_torch.ops.density import apply_readout_confusion

    T, B = 4, 3
    conf = _asymmetric_confusion(rng, nq)
    eng = _engine_with_confusion(nq, conf, T)
    probs = rng.random((B * T, 2 ** nq)) ** 4
    probs /= probs.sum(axis=1, keepdims=True)
    total = rng.uniform(0.5, 2.0, (B * T, 1)) if scaled else 1.0
    probs = torch.as_tensor((probs * total).astype(np.float32))
    flip = torch.as_tensor(rng.choice([-1.0, 1.0], (B * T, nq))
                           .astype(np.float32))
    want = (apply_readout_confusion(probs, torch.as_tensor(
        conf.astype(np.float32)), nq) @ eng._neg_bit_pm) * flip
    got = eng.trajectory_z(probs, flip)
    assert got.shape == (B, T, nq)
    tol = 1e-6 * np.broadcast_to(total, (B * T, nq))
    assert np.all(np.abs(got.reshape(B * T, nq).numpy() - want.numpy())
                  <= tol)


def test_trajectory_z_confuses_before_the_flip(rng):
    """The JAX engine's order, flip·(a·z + b·T), and not the light-cone
    engine's a·(flip·z) + b·T: under an asymmetric confusion the two
    differ by 2·b·T where the flip is −1."""
    from mlqem_tpu_torch.ops.density import readout_affine

    nq, T = 2, 1
    conf = _asymmetric_confusion(rng, nq)
    eng = _engine_with_confusion(nq, conf, T)
    probs = np.array([[0.5, 0.1, 0.3, 0.1], [0.05, 0.6, 0.1, 0.25]])
    probs *= np.array([[1.0], [1.7]])
    flip = np.array([[-1.0, 1.0], [-1.0, -1.0]])
    z = probs @ eng._neg_bit_pm.numpy().astype(np.float64)
    total = probs.sum(axis=1, keepdims=True)
    a, b = np.array([readout_affine(c) for c in conf]).T
    got = eng.trajectory_z(torch.as_tensor(probs, dtype=torch.float32),
                           torch.as_tensor(flip, dtype=torch.float32)
                           ).reshape(2, nq).numpy()
    np.testing.assert_allclose(got, flip * (a * z + b * total), atol=1e-6,
                               rtol=0)
    swapped = a * (flip * z) + b * total
    assert np.all(np.abs(got - swapped)[flip < 0] > 0.05)


def test_generate_reads_out_without_the_distribution(monkeypatch):
    """With readout on, ``generate`` never confuses the distribution, and
    records one ``kicked.confusion`` span a call."""
    import mlqem_tpu_torch.ops.density as t_density
    import mlqem_tpu_torch.ops.kicked_ising as t_kicked
    from mlqem_tpu_torch.utils.profiling import (reset_spans, span_totals,
                                                 tracing)

    def refuse(*args, **kwargs):
        raise AssertionError("the kicked engine confused the distribution")

    monkeypatch.setattr(t_density, "apply_readout_confusion", refuse)
    monkeypatch.setattr(t_kicked, "apply_readout_confusion", refuse,
                        raising=False)
    eng = KickedIsingEngine(configurable_device(6, seed=0), nq=6, steps=2,
                            device="cpu", n_traj=4)
    assert eng.tables.confusion is not None
    calls = 3
    reset_spans()
    try:
        with tracing():
            for seed in range(calls):
                ideal, noisy = eng.generate(np.array([0.2, 0.4]), seed=seed)
        spans = span_totals()
    finally:
        reset_spans()
    assert np.isfinite(noisy).all() and noisy.shape == (2, 6)
    assert spans["kicked.generate"]["count"] == calls
    assert spans["kicked.generate/kicked.readout/kicked.confusion"][
        "count"] == calls
