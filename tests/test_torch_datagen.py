"""Port vs JAX package: the label pipeline as a whole.

Both pipelines take the same Pauli draws, made with numpy: the JAX
pipeline imports ``sample_small_categorical`` from ``mlqem_tpu.ops.
sampling`` while it traces, and the port's calls ``mlqem_tpu_torch.ops.
sampling``'s, so patching both module attributes hands them the same
draws. With ``shots=None`` everything after the draws is deterministic and
is held to 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlqem_tpu.ops.sampling as j_sampling
from mlqem_tpu.device.registry import configurable_device as j_configurable
from mlqem_tpu.parallel.datagen import IsingLabelPipeline as JPipeline

import mlqem_tpu_torch.ops.sampling as t_sampling
from mlqem_tpu_torch import IsingLabelPipeline, configurable_device
from mlqem_tpu_torch.convert import pipeline_tables_from_numpy
from mlqem_tpu_torch.utils.profiling import reset_spans, span_totals, tracing


def _share_draws(monkeypatch, draws):
    def j_sample(key, probs, shape):
        assert tuple(shape) == draws.shape
        return jnp.asarray(draws)

    def t_sample(probs, shape, generator):
        assert tuple(shape) == draws.shape
        return torch.as_tensor(draws)

    monkeypatch.setattr(j_sampling, "sample_small_categorical", j_sample)
    monkeypatch.setattr(t_sampling, "sample_small_categorical", t_sample)


def _pipelines(method, nq, readout, h, **kw):
    kw = dict(nq=nq, steps=2, dt=0.25, h=h, shots=None, readout=readout,
              method=method, n_traj=8, **kw)
    return (IsingLabelPipeline(configurable_device(nq, seed=0),
                               device="cpu", **kw),
            JPipeline(j_configurable(nq, seed=0), **kw))


@pytest.mark.parametrize("method,nq,readout,h", [
    ("frame", 4, True, 1.0), ("frame", 6, False, None),
    ("trajectory_gather", 4, False, None),
    ("trajectory_gather", 6, True, 1.0)])
def test_labels_match_jax_on_shared_draws(method, nq, readout, h, rng,
                                          monkeypatch):
    B = 3
    pipe, jpipe = _pipelines(method, nq, readout, h)
    # the port builds the same tables itself; assert it, then force them
    np.testing.assert_allclose(pipe.tables.pauli_probs.numpy(),
                               jpipe._pauli_probs, atol=1e-7, rtol=0)
    assert (pipe.tables.confusion is None) == (jpipe._confusion is None)
    pipe.tables = pipeline_tables_from_numpy(jpipe._pauli_probs,
                                             jpipe._confusion, device="cpu")
    # mostly identity, plus a share of uniform Paulis on every op
    draws = rng.integers(0, 16, size=(B, 8, pipe.ct_struct.max_ops)
                         ).astype(np.int32)
    draws[rng.random(draws.shape) < 0.7] = 0
    _share_draws(monkeypatch, draws)
    J = rng.uniform(0.05, 0.6, size=B).astype(np.float32)
    hv = None if h is not None else rng.uniform(0.5, 1.5, B).astype(
        np.float32)
    ideal, noisy = pipe.generate(J, h_values=hv, seed=0)
    j_ideal, j_noisy = jpipe.generate(J, h_values=hv, seed=0)
    assert ideal.shape == noisy.shape == (B, nq)
    np.testing.assert_allclose(ideal, j_ideal, atol=1e-5, rtol=0)
    np.testing.assert_allclose(noisy, j_noisy, atol=1e-5, rtol=0)
    assert np.abs(noisy - ideal).max() > 1e-3


def test_frame_matches_gather_on_the_same_seed():
    J = np.array([0.1, 0.35, 0.6], np.float32)
    out = {}
    for method in ("frame", "trajectory_gather"):
        pipe = IsingLabelPipeline(configurable_device(5, seed=0), nq=5,
                                  steps=2, device="cpu", shots=None,
                                  method=method, n_traj=16)
        out[method] = pipe.generate(J, seed=7)
    for got, want in zip(out["frame"], out["trajectory_gather"]):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_shot_noise_within_five_sigma():
    nq, T, shots = 5, 16, 4000
    J = np.random.default_rng(5).uniform(0.05, 0.6, size=4)
    kw = dict(nq=nq, steps=2, device="cpu", method="frame", n_traj=T)
    exact = IsingLabelPipeline(configurable_device(nq, seed=0), shots=None,
                               **kw)
    sampled = IsingLabelPipeline(configurable_device(nq, seed=0),
                                 shots=shots, **kw)
    # same seed → same noise draws, so only the binomial shots differ
    ideal0, noisy0 = exact.generate(J, seed=11)
    ideal1, noisy1 = sampled.generate(J, seed=11)
    np.testing.assert_array_equal(ideal0, ideal1)
    n = shots // T
    sigma = np.sqrt(1.0 / (n * T))      # var(mean) ≤ Σ 4p(1−p)/n / T²
    assert np.all(np.abs(noisy1 - noisy0) <= 5 * sigma)
    assert not np.array_equal(noisy1, noisy0)


def test_method_dispatch_and_refusals():
    dev = configurable_device(4, seed=0)
    default = IsingLabelPipeline(dev, nq=4, steps=1, device="cpu",
                                 shots=None)
    assert default.method == "density_matrix"      # the JAX default
    ideal, noisy = default.generate(np.array([0.2, 0.4]))
    assert ideal.shape == noisy.shape == (2, 4)
    assert np.isfinite(noisy).all() and (np.abs(noisy) <= 1).all()
    with pytest.raises(ValueError, match="method"):
        IsingLabelPipeline(dev, nq=4, steps=1, device="cpu", method="dm")
    with pytest.raises(ValueError, match="CUDA"):
        IsingLabelPipeline(dev, nq=4, steps=1, device="cpu", method="frame",
                           use_kernel=True)
    pipe = IsingLabelPipeline(dev, nq=4, steps=1, device="cpu",
                              method="trajectory")
    assert pipe.method == "trajectory_gather"       # frame only on CUDA
    sym = IsingLabelPipeline(dev, nq=4, steps=1, device="cpu", h=None,
                             method="frame")
    with pytest.raises(ValueError, match="h_values"):
        sym.generate(np.array([0.2]))


def test_stage_marks_in_order():
    pipe = IsingLabelPipeline(configurable_device(4, seed=0), nq=4, steps=1,
                              device="cpu", method="frame", n_traj=4)
    gen = torch.Generator().manual_seed(0)
    reset_spans()
    with tracing():
        ideal, noisy = pipe.run(torch.tensor([[0.3], [0.5]]), gen)
    totals = span_totals()
    assert list(totals) == ["pipeline.frame", "pipeline.evolve",
                            "pipeline.readout", "pipeline.ideal"]
    assert all(t["count"] == 1 for t in totals.values())
    assert ideal.shape == noisy.shape == (2, 4)
    assert torch.isfinite(noisy).all() and (noisy.abs() <= 1).all()


@pytest.mark.parametrize("nq", [10, 13, 14, 20])
def test_frame_pipeline_picks_the_engine_for_its_width(nq, monkeypatch):
    """``method="frame"`` calls K2's wrapper at every width (on the CPU the
    wrapper runs its plain version, so the calls are counted here in place
    of the card's launches); ``"trajectory"`` runs the frame engine on a
    CUDA device at every width K2 takes, as the JAX package does on its
    accelerator, and the gather engine elsewhere; ``use_kernel=True``
    raises at construction wherever the engine is not K2."""
    import mlqem_tpu_torch.parallel.datagen as dg

    calls = {}
    for name in ("evolve_frame_marginals", "evolve_frame_marginals_reference",
                 "run_trajectories_presampled"):
        def counted(*a, _fn=getattr(dg, name), _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a)
        monkeypatch.setattr(dg, name, counted)
    kw = dict(nq=nq, steps=1, device="cpu", shots=None, n_traj=1)
    pipe = IsingLabelPipeline(configurable_device(nq, seed=0),
                              method="frame", **kw)
    assert pipe.noisy_engine == "k2"
    J = np.array([0.3], np.float32)
    got = pipe.generate(J, seed=0)
    assert calls == {"evolve_frame_marginals": 1}
    gather = IsingLabelPipeline(configurable_device(nq, seed=0),
                                method="trajectory", **kw)
    assert gather.method == gather.noisy_engine == "trajectory_gather"
    if nq <= 14:
        # the gather engine on the same seed (the same draws) agrees
        for a, b in zip(got, gather.generate(J, seed=0)):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    else:
        assert all(np.isfinite(a).all() and a.shape == (1, nq) for a in got)
    cuda_pick = dg.choose_noisy_engine("trajectory", "cuda", nq, True, None)
    assert cuda_pick == ("frame", "k2")
    assert dg.choose_noisy_engine("trajectory", "cuda", nq, False, None) == (
        "trajectory_gather", "trajectory_gather")
    assert dg.choose_noisy_engine("trajectory", "cpu", nq, True, None) == (
        "trajectory_gather", "trajectory_gather")
    for use_kernel in (None, True):
        assert dg.choose_noisy_engine("frame", "cuda", nq, True,
                                      use_kernel) == ("frame", "k2")
    assert dg.choose_noisy_engine("frame", "cuda", nq, True, False) == (
        "frame", "k2_plain")
    assert dg.choose_noisy_engine("trajectory", "cuda", nq, True,
                                  True) == ("frame", "k2")
    with pytest.raises(ValueError, match="trajectory_gather"):
        dg.choose_noisy_engine("trajectory", "cuda", nq, False, True)
    for method in ("trajectory_gather", "density_matrix"):
        with pytest.raises(ValueError, match=method):
            dg.choose_noisy_engine(method, "cuda", nq, True, True)
