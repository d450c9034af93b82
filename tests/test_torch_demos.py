"""Port vs JAX package: the demo reproductions (demo1's 100-qubit ZNE
mimicry pipeline, cut to 10 qubits and 4 steps here, and demo2).

demo1's engine arms take the same noise draws on both sides (a sampler
that depends only on the draw's shape, patched into both packages, as in
``tests/test_torch_lightcone.py``); with ``shots=None`` they are held to
1e-5. Its post-processing (rows, the RF mimics, every RMSE) runs on arms
one package wrote to its npz cache and the other read: ≤ 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlqem_tpu.ops.sampling as j_sampling
from mlqem_tpu.workflows import demos as jdemos

import mlqem_tpu_torch.ops.sampling as t_sampling
from mlqem_tpu_torch.workflows import demos as tdemos

from port_fixtures import one_torch_thread  # noqa: F401

NQ, STEPS = 10, 4
DEMO1 = dict(nq=NQ, num_steps=STEPS, num_circ_per_step=5, train_per_step=2,
             qubits=(1, 5, 8), shots=None, num_twirls=3, num_twirls_amp=2,
             n_estimators=10, seed=0)
POST_TOL = 1e-6


def _shape_draws(shape):
    rng = np.random.default_rng(sum(shape) * 7 + len(shape))
    draws = rng.integers(0, 16, size=shape).astype(np.int32)
    draws[rng.random(shape) < 0.8] = 0
    return draws


@pytest.fixture(scope="module")
def demo1_runs(tmp_path_factory):
    """JAX's and the port's demo1 on shared draws, each writing its cache,
    and each package's post-processing of the other's cache."""
    mp = pytest.MonkeyPatch()
    mp.setattr(j_sampling, "sample_small_categorical",
               lambda key, probs, shape: jnp.asarray(
                   _shape_draws(tuple(shape))))
    mp.setattr(t_sampling, "sample_small_categorical",
               lambda probs, shape, generator: torch.as_tensor(
                   _shape_draws(tuple(shape))))
    tmp = tmp_path_factory.mktemp("demo1")
    j_cache, t_cache = str(tmp / "jax.npz"), str(tmp / "port.npz")
    try:
        want = jdemos.demo1_zne_mimic_100q(arrays_cache=j_cache, **DEMO1)
        got = tdemos.demo1_zne_mimic_100q(arrays_cache=t_cache,
                                          device="cpu", **DEMO1)
    finally:
        mp.undo()
    # each package post-processes the other's cache (no engine runs: the
    # samplers are the real ones again and would differ)
    got_from_j = tdemos.demo1_zne_mimic_100q(arrays_cache=j_cache,
                                             device="cpu", **DEMO1)
    want_from_t = jdemos.demo1_zne_mimic_100q(arrays_cache=t_cache,
                                              **DEMO1)
    return {"want": want, "got": got, "got_from_j": got_from_j,
            "want_from_t": want_from_t, "j_cache": j_cache,
            "t_cache": t_cache}


def test_demo1_engine_arms_match_jax(demo1_runs):
    j, t = np.load(demo1_runs["j_cache"]), np.load(demo1_runs["t_cache"])
    assert set(t.files) == set(j.files)
    for k in ("noisy_sw", "amp_sw", "ideal_sw"):
        assert t[k].shape == j[k].shape == (5, STEPS, 3)
        np.testing.assert_allclose(t[k], j[k], atol=1e-5, rtol=0,
                                   err_msg=k)
    for k in set(j.files) - {"noisy_sw", "amp_sw", "ideal_sw"}:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    # the part files sit in the same hash-named directory
    import os
    parts = sorted(p for p in os.listdir(os.path.dirname(
        demo1_runs["t_cache"])) if ".parts-" in p)
    assert [p.split(".parts-")[1] for p in parts[:1]] == \
        [p.split(".parts-")[1] for p in parts[1:]]


def _same_outputs(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k == "rows":
            assert len(got[k]) == len(v)
            for a, b in zip(got[k], v):
                assert a.keys() == b.keys()
                assert (a["step"], a["J"], a["split"]) == \
                    (b["step"], b["J"], b["split"])
                for f in ("noisy", "zne", "ideal"):
                    np.testing.assert_allclose(a[f], b[f], atol=POST_TOL,
                                               rtol=0)
        elif isinstance(v, dict):
            assert got[k].keys() == v.keys()
            for kk in v:
                np.testing.assert_allclose(got[k][kk], v[kk], atol=POST_TOL,
                                           rtol=0, err_msg=(k, kk))
        elif isinstance(v, str) or v is None:
            assert got[k] == v
        else:
            np.testing.assert_allclose(got[k], v, atol=POST_TOL, rtol=0,
                                       err_msg=k)


def test_demo1_postprocessing_of_a_jax_cache(demo1_runs):
    """The port reads the cache JAX wrote: rows, mimics, RMSEs ≤ 1e-6."""
    _same_outputs(demo1_runs["got_from_j"], demo1_runs["want"])


def test_jax_reads_the_port_cache(demo1_runs):
    _same_outputs(demo1_runs["want_from_t"], demo1_runs["got"])


def test_demo1_j00_clifford_row(demo1_runs):
    """Row J00 is the campaign's Clifford J=0 circuit (kick h=0.5π): its
    ideal values are cos(s·π/2); the others take the h=0.66π kick."""
    rows = demo1_runs["got"]["rows"]
    j0 = sorted((r for r in rows if r["J"] == 0.0), key=lambda r: r["step"])
    assert len(j0) == STEPS
    for r in j0:
        np.testing.assert_allclose(np.asarray(r["ideal"]),
                                   np.cos(r["step"] * np.pi / 2.0),
                                   atol=1e-5)
    others = [r for r in rows if r["J"] != 0.0 and r["step"] == 1]
    assert max(float(np.abs(r["ideal"]).max()) for r in others) > 0.05


def test_demo1_pauli_prop_matches_jax_and_unknown_engine_is_refused(
        tmp_path):
    """demo1's sparse Pauli-propagation engine: the engine arms, J00 row
    and truncation discard equal JAX's within 1e-5; the port
    post-processes JAX's cache as JAX does (≤ 1e-6). An unknown engine is
    refused."""
    j_cache, t_cache = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    want = jdemos.demo1_zne_mimic_100q(engine="pauli_prop",
                                       arrays_cache=j_cache, **DEMO1)
    got = tdemos.demo1_zne_mimic_100q(engine="pauli_prop", device="cpu",
                                      arrays_cache=t_cache, **DEMO1)
    j, t = np.load(j_cache), np.load(t_cache)
    assert set(t.files) == set(j.files) and str(t["engine"]) == "pauli_prop"
    for k in ("noisy_sw", "amp_sw", "ideal_sw", "max_disc"):
        np.testing.assert_allclose(t[k], j[k], atol=1e-5, rtol=0,
                                   err_msg=k)
    assert float(t["max_disc"]) > 0.0        # K = 8192 truncates here
    assert got["engine"] == "pauli_prop"
    _same_outputs(tdemos.demo1_zne_mimic_100q(
        engine="pauli_prop", device="cpu", arrays_cache=j_cache, **DEMO1),
        want)
    j0 = sorted((r for r in got["rows"] if r["J"] == 0.0),
                key=lambda r: r["step"])
    for r in j0:
        np.testing.assert_allclose(np.asarray(r["ideal"]),
                                   np.cos(r["step"] * np.pi / 2.0),
                                   atol=1e-5)
    with pytest.raises(ValueError, match="unknown engine"):
        tdemos.demo1_zne_mimic_100q(engine="dm", device="cpu", **DEMO1)


def test_demo2_matches_jax():
    kw = dict(num_steps=3, num_train=12, shots=None, seed=0)
    got = tdemos.demo2_ising_4q(device="cpu", **kw)
    want = jdemos.demo2_ising_4q(**kw)
    assert got.keys() == want.keys()
    assert got["steps"] == want["steps"] == [0, 1, 2, 3]
    for k, v in want.items():
        if k != "steps":
            np.testing.assert_allclose(got[k], v, atol=1e-4, rtol=0,
                                       err_msg=k)
