"""Port vs JAX package: the light-cone engine and its cross-check.

The noisy arms take the same noise draws on both sides: the JAX engine
imports ``sample_small_categorical`` from ``mlqem_tpu.ops.sampling`` when
it builds a window's program, and the port calls
``mlqem_tpu_torch.ops.sampling``'s, so patching both module attributes with
a sampler that depends only on the shape hands them the same draws. With
``shots=None`` everything after the draws is deterministic and is held to
float rounding (1e-5). On the CPU the port runs K3's plain version at
every width.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlqem_tpu.ops.sampling as j_sampling
from mlqem_tpu.device.noise import NoiseModel as JNoiseModel
from mlqem_tpu.device.registry import configurable_device as j_configurable
from mlqem_tpu.ops.lightcone import LightconeIsing as JLightcone
from mlqem_tpu.ops.pauli_prop import PauliPropagatorIsing

import mlqem_tpu_torch.ops.sampling as t_sampling
from mlqem_tpu_torch import KickedIsingEngine, LightconeIsing, NoiseModel
from mlqem_tpu_torch import configurable_device
from mlqem_tpu_torch.ops.kernels import fused_step as kfs
from mlqem_tpu_torch.ops.lightcone import cone_window, readout_affine
from mlqem_tpu_torch.workflows.demos import lightcone_crosscheck

DT, H = 0.5, 0.5 * np.pi
J = np.array([0.05, 0.3, 0.55], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs six workers on a
    few cores, and torch's thread pool, oversubscribed, makes these small
    ops tens of times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _shape_draws(shape):
    """Draws that depend only on their shape: mostly identity, plus a share
    of uniform Paulis so every frame path is taken."""
    rng = np.random.default_rng(sum(shape) * 7 + len(shape))
    draws = rng.integers(0, 16, size=shape).astype(np.int32)
    draws[rng.random(shape) < 0.8] = 0
    return draws


@pytest.fixture
def shared_draws(monkeypatch):
    def j_sample(key, probs, shape):
        return jnp.asarray(_shape_draws(tuple(shape)))

    def t_sample(probs, shape, generator):
        return torch.as_tensor(_shape_draws(tuple(shape)))

    monkeypatch.setattr(j_sampling, "sample_small_categorical", j_sample)
    monkeypatch.setattr(t_sampling, "sample_small_categorical", t_sample)


def test_cone_window_clamps():
    assert cone_window(0, 3, 10) == (0, 7)      # left edge
    assert cone_window(9, 3, 10) == (3, 7)      # right edge
    assert cone_window(5, 3, 10) == (2, 7)      # interior
    assert cone_window(5, 8, 10) == (0, 10)     # cone wider than chain


def test_readout_affine_closed_form():
    C = np.array([[0.97, 0.08], [0.03, 0.92]])   # asymmetric, col-stochastic
    a, b = readout_affine(C)
    assert a == pytest.approx((0.97 - 0.03 + 0.92 - 0.08) / 2)
    assert b == pytest.approx((0.97 - 0.03 - 0.92 + 0.08) / 2)
    assert readout_affine(None) == (1.0, 0.0)


# (nq, steps, qubits): w = 7 (the K3 path), 13 (K3's path; JAX's wht_mm
# branch) and 15 (K4's path on the card: WHTs and phases apart)
WIDTHS = [(10, 3, (0, 4, 9)), (14, 6, (0, 7)), (16, 7, (8,))]


@pytest.mark.parametrize("nq,steps,qubits", WIDTHS)
def test_ideal_arm_matches_jax(nq, steps, qubits):
    kw = dict(nq=nq, steps=steps, dt=DT, h=0.66 * np.pi, n_traj=1,
              shots=None, noise=False, readout=False)
    _, want = JLightcone(j_configurable(nq, seed=1), **kw).generate_stepwise(
        J, qubits=qubits)
    eng = LightconeIsing(configurable_device(nq, seed=1), device="cpu", **kw)
    got = eng.ideal_stepwise(J, qubits=qubits)
    assert got.shape == (len(J), steps, len(qubits))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    _, got2 = eng.generate_stepwise(J, qubits=qubits)
    np.testing.assert_array_equal(got2, got)


@pytest.mark.parametrize("nq,steps,qubits", WIDTHS)
def test_noisy_arm_matches_jax_on_shared_draws(nq, steps, qubits,
                                               shared_draws):
    kw = dict(nq=nq, steps=steps, dt=DT, h=H, n_traj=4, shots=None)
    jeng = JLightcone(j_configurable(nq, seed=1), **kw)
    eng = LightconeIsing(configurable_device(nq, seed=1), device="cpu", **kw)
    for tw_q in qubits:
        jtw, tw = jeng._window_tables(tw_q), eng.window_tables(tw_q)
        assert tw["bonds"] == jtw["bonds"] and tw["obs"] == jtw["obs"]
        np.testing.assert_allclose(tw["probs"], jtw["probs"], atol=1e-7)
    for ns in (1, 3):
        j_noisy, j_ideal = jeng.generate_stepwise(
            J[:2], noise_scale=ns, qubits=qubits, readout_correct=True)
        noisy, ideal = eng.generate_stepwise(
            J[:2], noise_scale=ns, qubits=qubits, readout_correct=True)
        np.testing.assert_allclose(ideal, j_ideal, atol=1e-5, rtol=0)
        np.testing.assert_allclose(noisy, j_noisy, atol=1e-5, rtol=0)
        assert np.abs(noisy - ideal).max() > 1e-3      # the noise acts


def test_noninteger_noise_factor_rejected():
    lc = LightconeIsing(configurable_device(10, seed=1), nq=10, steps=2,
                        device="cpu", n_traj=2, shots=None)
    with pytest.raises(ValueError, match="integer"):
        lc.generate_stepwise(J, noise_scale=1.5, qubits=(0,))


def test_t_chunk_deterministic_exact_and_rejected():
    """Equal t_chunk blocks with independent streams: deterministic, and
    they converge to the exact twirled channel (Pauli propagation)."""
    nq, steps = 10, 3
    ref, _ = PauliPropagatorIsing(j_configurable(nq, seed=1), nq=nq,
                                  steps=steps, dt=DT, h=H, max_terms=8192,
                                  readout=False).generate_stepwise(
        J, noise_scale=1, qubits=(0, 4, 9))
    lc = LightconeIsing(configurable_device(nq, seed=1), nq=nq, steps=steps,
                        device="cpu", dt=DT, h=H, n_traj=3072, t_chunk=1024,
                        shots=None, readout=False)
    got, _ = lc.generate_stepwise(J, qubits=(0, 4, 9), seed=1)
    got2, _ = lc.generate_stepwise(J, qubits=(0, 4, 9), seed=1)
    np.testing.assert_array_equal(got, got2)
    assert np.abs(got - ref).max() < 0.04
    # the chunks draw apart: a single chunk's mean is not the whole mean
    one = LightconeIsing(configurable_device(nq, seed=1), nq=nq, steps=steps,
                         device="cpu", dt=DT, h=H, n_traj=1024, shots=None,
                         readout=False).generate_stepwise(
        J, qubits=(0, 4, 9), seed=1)[0]
    assert not np.array_equal(one, got)
    with pytest.raises(ValueError, match="t_chunk"):
        LightconeIsing(configurable_device(nq, seed=1), nq=nq, steps=steps,
                       device="cpu", n_traj=10, t_chunk=4)


def test_readout_correction_inverts_confusion():
    """readout_correct=True undoes the confusion affine exactly at
    shots=None, under CX channels at both ZNE noise factors."""
    nq, dev = 10, configurable_device(10, seed=1)
    nm_clean = NoiseModel.from_device(dev)
    nm_clean.readout = None
    kw = dict(nq=nq, steps=2, device="cpu", dt=DT, h=H, n_traj=8,
              shots=None)
    lc = LightconeIsing(dev, noise_model=NoiseModel.from_device(dev), **kw)
    lc_clean = LightconeIsing(dev, noise_model=nm_clean, **kw)
    for nf in (1, 3):
        got, _ = lc.generate_stepwise(J, noise_scale=nf, qubits=(0, 4, 9),
                                      seed=3, readout_correct=True)
        ref, _ = lc_clean.generate_stepwise(J, noise_scale=nf,
                                            qubits=(0, 4, 9), seed=3)
        assert np.abs(got - ref).max() < 1e-6, nf
        raw, _ = lc.generate_stepwise(J, noise_scale=nf, qubits=(0, 4, 9),
                                      seed=3)
        assert np.abs(raw - ref).max() > 1e-3, nf


def test_shot_sampling_is_binomial():
    """shots=N draws real counts: unbiased and within ~5σ of the binomial
    spread around the exact value."""
    dev = configurable_device(10, seed=1)
    kw = dict(nq=10, steps=2, device="cpu", dt=DT, h=H, noise=False,
              readout=False)
    ideal = LightconeIsing(dev, n_traj=1, shots=None, **kw).ideal_stepwise(
        J, qubits=(0, 4, 9))
    shots = 4096
    got, _ = LightconeIsing(dev, n_traj=4, shots=shots, **kw
                            ).generate_stepwise(J, qubits=(0, 4, 9), seed=7)
    sigma = 1.0 / np.sqrt(4 * shots)   # worst case p=1/2, 4 trajectories
    diff = np.abs(got - ideal)
    assert diff.max() < 5 * sigma + 1e-6
    assert diff.max() > 0              # sampling happened


def test_cone_is_exact_against_the_full_chain():
    """The light-cone ideal arm (w=7 windows on a 9-qubit chain) equals the
    kicked-Ising engine's full-chain ideal labels at every depth."""
    nq, steps = 9, 3
    dev = configurable_device(nq, seed=0)
    Jv = np.array([0.1, 0.45], np.float32)
    lc = LightconeIsing(dev, nq=nq, steps=steps, device="cpu", dt=0.25,
                        h=1.0, n_traj=1, shots=None, noise=False,
                        readout=False)
    got = lc.ideal_stepwise(Jv)                       # [B, steps, nq]
    for s in range(1, steps + 1):
        want, _ = KickedIsingEngine(dev, nq=nq, steps=s, device="cpu",
                                    dt=0.25, h=1.0, n_traj=1, shots=None
                                    ).generate(Jv, seed=0)
        np.testing.assert_allclose(got[:, s - 1], want, atol=1e-5, rtol=0)


def test_wide_window_through_the_emulated_passes(monkeypatch):
    """A 15-qubit window's arms through K3's plain version equal those
    through the wide tier's passes (``fused_trotter_step_passes``, three
    high passes at tile_bits=8), on the same draws."""
    dev = configurable_device(15, seed=1)
    lc = LightconeIsing(dev, nq=15, steps=7, device="cpu", dt=DT, h=1.3,
                        n_traj=2, shots=None)
    noisy, ideal = lc.generate_stepwise(J[:2], qubits=(7,), seed=2)
    calls = []

    def passes(*args, masks=None):
        calls.append(masks)
        return kfs.fused_trotter_step_passes(*args, tile_bits=8,
                                             masks=masks)

    monkeypatch.setattr(kfs, "fused_trotter_step", passes)
    noisy2, ideal2 = lc.generate_stepwise(J[:2], qubits=(7,), seed=2)
    # 7 steps of the noisy arm and of the ideal arm, the masks built once
    # an arm
    assert len(calls) == 14 and calls[0] is calls[6]
    np.testing.assert_allclose(noisy2, noisy, atol=1e-6, rtol=0)
    np.testing.assert_allclose(ideal2, ideal, atol=1e-6, rtol=0)


@pytest.mark.parametrize("use_kernel", [None, False])
def test_frame_signs_take_the_plain_version_on_the_cpu(use_kernel,
                                                       monkeypatch):
    """On the CPU a window's frame pass is the plain version, through the
    wrapper by default and directly with use_kernel=False, at a window
    that starts past qubit 0; the kernel's entry is never reached."""
    from mlqem_tpu_torch.ops.kernels import frames as kfr

    def refuse(*a, **kw):
        raise AssertionError("the kernel entry was reached")

    wrapper = kfr.propagate_frames
    monkeypatch.setattr(kfr, "_launch", refuse)
    monkeypatch.setattr(kfr, "load_library", refuse)
    if use_kernel is False:
        monkeypatch.setattr(kfr, "propagate_frames", refuse)
    steps, rows = 4, 24
    eng = LightconeIsing(configurable_device(20, seed=0), nq=20,
                         steps=steps, device="cpu", use_kernel=use_kernel)
    tw = eng.window_tables(9)
    assert tw["start"] == 5 and tw["bonds"][0] == (1, 2)
    draws = torch.as_tensor(_shape_draws((steps, rows, len(tw["bonds"]),
                                          2)))
    before = wrapper.launches
    kick, bond, flip = eng.frame_signs(draws, tw)
    want_kick, want_bond, x_after = kfr.propagate_frames_reference(
        draws, tw["bonds"], tw["w"])
    assert torch.equal(kick, want_kick) and torch.equal(bond, want_bond)
    assert torch.equal(flip, (1 - 2 * ((x_after >> tw["obs"]) & 1)).float())
    assert (flip == -1).any() and (bond == -1).any()
    assert wrapper.launches == before


def test_constructor_checks():
    dev = configurable_device(40, seed=1)
    with pytest.raises(ValueError, match="32 qubits"):
        LightconeIsing(dev, nq=40, steps=16, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        LightconeIsing(dev, nq=10, steps=2, device="cpu", use_kernel=True)


def test_crosscheck_against_precomputed_reference():
    """The port's lightcone_crosscheck passes against Pauli-propagation
    values computed by the JAX package, at a small chain."""
    nq, steps, qubits = 10, 3, (0, 4, 9)
    jdev = j_configurable(nq, seed=1)
    kw = dict(nq=nq, steps=steps, dt=DT, h=H, max_terms=4096)
    reference = {"ideal": PauliPropagatorIsing(jdev, noise=False, **kw)
                 .generate_stepwise(J, qubits=qubits)[0]}
    pp = PauliPropagatorIsing(jdev, **kw)
    for nf in (1, 3):
        reference[f"nf{nf}"] = pp.generate_stepwise(
            J, noise_scale=nf, qubits=qubits)[0]
    kw = dict(nq=nq, steps=steps, qubits=qubits, n_traj=2048,
              noisy_tol=0.04, max_terms=4096, device="cpu")
    out = lightcone_crosscheck(reference=reference, **kw)
    assert out["passed"], out
    assert out["ideal_max_diff"] < 1e-5
    assert set(out["noisy_max_diff"]) == {"nf1", "nf3"}
    assert out["config"]["reference"] == "precomputed"
    # reference=None recomputes the same values with the port's engine
    own = lightcone_crosscheck(reference=None, **kw)
    assert own["config"] == {**out["config"], "reference": "recomputed"}
    assert own["passed"] == out["passed"]
    assert own["ideal_max_diff"] == pytest.approx(out["ideal_max_diff"],
                                                  abs=1e-6)
    for arm, v in out["noisy_max_diff"].items():
        assert own["noisy_max_diff"][arm] == pytest.approx(v, abs=1e-6)


def test_noise_model_scale_matches_jax():
    """demo1's calibrated channel scale builds the same window tables."""
    kw = dict(nq=30, steps=10)
    jdev, dev = j_configurable(30, seed=1), configurable_device(30, seed=1)
    jeng = JLightcone(jdev, noise_model=JNoiseModel.from_device(
        jdev, scale=2.5), **kw)
    eng = LightconeIsing(dev, device="cpu", noise_model=NoiseModel.from_device(
        dev, scale=2.5), **kw)
    for q in (0, 11, 29):
        jtw, tw = jeng._window_tables(q), eng.window_tables(q)
        assert (tw["start"], tw["w"], tw["obs"], tw["bonds"]) == (
            jtw["start"], jtw["w"], jtw["obs"], jtw["bonds"])
        np.testing.assert_allclose(tw["probs"], jtw["probs"], atol=1e-7)
        np.testing.assert_allclose(tw["confusion"], jtw["confusion"],
                                   atol=1e-12)
