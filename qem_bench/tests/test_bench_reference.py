"""The plain reference against the port's plain CPU path at tiny widths,
and the frozen calibration draw against the port's ``configurable_device``.
(The tests read the port; the reference itself never does.)"""
import numpy as np
import pytest
import torch

from qem_bench import calibration, check
from qem_bench.entries import kicked as kref
from qem_bench.entries import lightcone as lref
from qem_bench.reference import noise as rnoise

CPU = torch.device("cpu")
CFG = dict(nq=5, steps=3, dt=0.25, h=1.0, readout=True, noise_scale=1.0)


@pytest.mark.parametrize("n,seed", [(10, 0), (100, 1), (7, 3)])
def test_calibration_is_configurable_device(n, seed):
    from mlqem_tpu_torch.device.registry import configurable_device

    got = calibration.device_model(calibration.line_device(n, seed))
    assert got.to_dict() == configurable_device(n, seed=seed).to_dict()


@pytest.mark.parametrize("scale", [1.0, 2.5])
def test_cx_noise_and_readout_as_the_port_derives_them(scale):
    from mlqem_tpu_torch.device.noise import NoiseModel
    from mlqem_tpu_torch.ops.trajectory import pauli_channel_probs

    cal = calibration.line_device(6, 2)
    nm = NoiseModel.from_device(calibration.device_model(cal), scale=scale)
    for a in range(5):
        want = pauli_channel_probs(nm.channel_for("cx", (a, a + 1)))
        got = rnoise.cx_pauli_probs(cal, a, a + 1, scale)
        assert np.abs(got - want).max() < 1e-12
    for q in range(6):
        c = nm.readout[q]
        assert rnoise.readout_scale(cal, q, scale) == pytest.approx(
            c[0, 0] - c[1, 0], abs=1e-15)


def test_kicked_ideal_matches_the_plain_engine():
    from mlqem_tpu_torch.ops.kicked_ising import KickedIsingEngine

    cal = calibration.line_device(CFG["nq"], 0)
    eng = KickedIsingEngine(calibration.device_model(cal), nq=CFG["nq"],
                            steps=CFG["steps"], device="cpu",
                            use_kernel=False, n_traj=4)
    J = np.linspace(0.05, 0.6, 7).astype(np.float32)
    ideal, _ = eng.generate(J, seed=1)
    assert check.ideal_max_err(ideal, kref.reference_ideal(CFG, J, CPU)) \
        < 2e-6


def test_kicked_noisy_mean_matches_the_plain_engine():
    from mlqem_tpu_torch.ops.kicked_ising import KickedIsingEngine

    cal = calibration.line_device(CFG["nq"], 0)
    eng = KickedIsingEngine(calibration.device_model(cal), nq=CFG["nq"],
                            steps=CFG["steps"], device="cpu",
                            use_kernel=False, n_traj=32, shots=None)
    J = np.full(2048, 0.4, np.float32)
    _, noisy = eng.generate(J, seed=3)
    gen = torch.Generator()
    gen.manual_seed(4)
    z = kref.reference_trajectories(CFG, cal, J[:1], 32768, 1, gen, CPU)
    mean, var, _ = check.moments(z, 1)
    se = np.sqrt(noisy.var(0) / len(J) + var[0] / 32768)
    assert (np.abs(noisy.mean(0) - mean[0]) < 5 * se).all()
    assert (np.abs(noisy.mean(0) - mean[0]) > 0).any()


def test_lightcone_ideal_matches_the_plain_engine():
    from mlqem_tpu_torch.ops.lightcone import LightconeIsing

    cfg = dict(nq=12, steps=3, dt=0.5, h=2.0734511513692637, noise_scale=2.5)
    cal = calibration.line_device(12, 1)
    eng = LightconeIsing(calibration.device_model(cal), nq=12, steps=3,
                         device="cpu", dt=0.5, h=cfg["h"], n_traj=1,
                         shots=None, noise=False, readout=False,
                         use_kernel=False)
    for q in (0, 5, 11):
        got = eng.ideal_stepwise(np.array([0.7], np.float32), [q])[0, :, 0]
        want = lref.reference_ideal(cfg, np.float32(0.7), q, CPU)
        assert np.abs(got - want).max() < 2e-6


def test_lightcone_noisy_mean_matches_the_plain_engine():
    from mlqem_tpu_torch.device.noise import NoiseModel
    from mlqem_tpu_torch.ops.lightcone import LightconeIsing

    cfg = dict(nq=12, steps=3, dt=0.5, h=2.0734511513692637, noise_scale=2.5)
    cal = calibration.line_device(12, 1)
    dm = calibration.device_model(cal)
    eng = LightconeIsing(dm, nq=12, steps=3, device="cpu", dt=0.5,
                         h=cfg["h"], n_traj=8192, shots=None,
                         noise_model=NoiseModel.from_device(dm, scale=2.5),
                         t_chunk=2048, use_kernel=False)
    q = 5
    noisy, _ = eng.generate_stepwise(np.array([0.7], np.float32), 1.0, [q],
                                     seed=9, want_ideal=False,
                                     readout_correct=True)
    gen = torch.Generator()
    gen.manual_seed(10)
    z = lref.reference_trajectories(cfg, cal, 0.7, q, 2, 16384, 1, gen, CPU)
    mean, var, _ = check.moments(z, 1)
    se = np.sqrt(var / 8192 + var / 16384)
    assert (np.abs(noisy[0, :2, 0] - mean) < 5 * se + 1e-6).all()


def test_folding_draws_the_composed_channel():
    """Three draws multiplied = the channel composed three times (the
    port's Walsh-domain composition)."""
    from mlqem_tpu_torch.ops.trajectory import compose_pauli_channel

    from qem_bench.reference.sim import draw_paulis

    cal = calibration.line_device(4, 0)
    p = rnoise.cx_pauli_probs(cal, 1, 2, 2.5)
    gen = torch.Generator()
    gen.manual_seed(0)
    n = 2_000_000
    ca, cb = draw_paulis(p, n, 3, gen, CPU)
    freq = np.bincount((4 * ca + cb).numpy(), minlength=16) / n
    want = compose_pauli_channel(p, 3)
    assert np.abs(freq - want).max() < 5 * np.sqrt(want.max() / n)
