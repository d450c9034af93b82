"""Port vs JAX package: the experiment workflows (datasets, the fitted
model-zoo arms, ZNE over datasets and mimicry)
and the noise settings they build on. The trained arms are in
``tests/test_torch_workflow_training.py``.

Both packages draw the circuits with numpy from the same seed, so the
circuits are compared exactly (``to_dict``). Labels are compared at
``shots=None`` (≤ 1e-5); the sampled case against the port's own exact
labels (5σ).
"""
import numpy as np
import pytest

from mlqem_tpu.circuits.families import IsingOptions as JIsingOptions
from mlqem_tpu.device.noise import add_coherent_cx_noise as j_coherent
from mlqem_tpu.device.registry import get_device as j_get_device
from mlqem_tpu.mitigation.zne import ZNEStrategy as JZNEStrategy
from mlqem_tpu.models.forest import RandomForestRegressor as JForest
from mlqem_tpu.models.linear import LinearRegression as JLinear
from mlqem_tpu.workflows import datasets as jd
from mlqem_tpu.workflows import mitigate as jmit

from mlqem_tpu_torch import (Circuit, LinearRegression, RandomForestRegressor,
                             ZNEStrategy, add_coherent_cx_noise, get_device)
from mlqem_tpu_torch.circuits.families import IsingOptions
from mlqem_tpu_torch.workflows import datasets as td
from mlqem_tpu_torch.workflows import mitigate as tmit

from port_fixtures import one_torch_thread  # noqa: F401

LABEL_TOL = 1e-5
CHANNEL_TOL = 1e-7

JDEV, DEV = j_get_device("fake_lima"), get_device("fake_lima")


def _same_channels(got, want):
    assert set(got.local_channels) == set(want.local_channels)
    assert set(got.default_channels) == set(want.default_channels)
    for k, ch in want.local_channels.items():
        np.testing.assert_allclose(got.local_channels[k].superop(),
                                   ch.superop(), atol=CHANNEL_TOL, rtol=0)
    assert (got.readout is None) == (want.readout is None)
    if want.readout is not None:
        np.testing.assert_allclose(got.readout, want.readout,
                                   atol=CHANNEL_TOL, rtol=0)


@pytest.mark.parametrize("setting", ["device", "coherent", "no_readout"])
def test_noise_settings_match_jax(setting):
    got = td.noise_setting(DEV, setting, seed=11, scale=1.5)
    want = jd.noise_setting(JDEV, setting, seed=11, scale=1.5)
    _same_channels(got, want)
    assert got.has_noise() and want.has_noise()
    assert (got.readout is None) == (setting == "no_readout")
    # a prebuilt model passes through
    assert td.noise_setting(DEV, got) is got


@pytest.mark.parametrize("kw", [
    dict(uniform=False, seed=3),
    dict(uniform=True, add_depolarization=False),
    dict(uniform=False, add_coherent=False, seed=4, scale=2.0)])
def test_add_coherent_cx_noise_matches_jax(kw):
    got = add_coherent_cx_noise(DEV, 0.1 * np.pi, **kw)
    want = j_coherent(JDEV, 0.1 * np.pi, **kw)
    _same_channels(got, want)
    # the CX channels are replaced and nothing else is
    plain = td.noise_setting(DEV, "device").without_gate("cx")
    assert {k for k in got.local_channels if k[0] != "cx"} == \
        set(plain.local_channels)
    assert plain.copy().without_readout().readout is None
    assert plain.readout is not None


def _builders(mod, dev):
    return {
        "ising": lambda **k: mod.ising_dataset(
            dev, num_circuits=6, steps_range=(0, 3), bases=("Z", "X"),
            shots=None, seed=3, **k),
        "ising_init_lower_route": lambda **k: mod.ising_dataset(
            dev, num_circuits=4, steps_range=(1, 3), shots=None,
            init_prefix=True, lower=True, route=True, seed=4, **k),
        "step_sweep": lambda **k: mod.ising_step_sweep(
            dev, (JIsingOptions if mod is jd else IsingOptions
                  ).config_4q_paper(), 3, shots=None, seed=1, **k),
        "mbl_cut": lambda **k: mod.mbl_dataset(
            dev, num_qubits=4, num_circuits=5, shots=None, seed=2,
            broken_connections=[(1, 2)], **k),
        "tiling": lambda **k: mod.tiling_dataset(
            dev, 2, 4, num_circuits=4, shots=None, seed=5, **k),
        "random": lambda **k: mod.random_circuit_dataset(
            dev, 4, 3, num_circuits=6, shots=None, seed=6, **k),
    }


@pytest.mark.parametrize("name", list(_builders(jd, JDEV)))
def test_dataset_matches_jax(name):
    """Circuits and meta identical; labels at shots=None ≤ 1e-5."""
    want = _builders(jd, JDEV)[name]()
    got = _builders(td, DEV)[name](device="cpu")
    assert len(got) == len(want)
    assert [c.to_dict() for c in got.circuits] == \
        [c.to_dict() for c in want.circuits]
    assert len(got.meta) == len(want.meta)
    for m_got, m_want in zip(got.meta, want.meta):
        assert m_got.keys() == m_want.keys()
        for k in m_want:
            np.testing.assert_array_equal(np.asarray(m_got[k]),
                                          np.asarray(m_want[k]))
    assert got.ideal.shape == got.noisy.shape == want.ideal.shape
    np.testing.assert_allclose(got.ideal, want.ideal, atol=LABEL_TOL, rtol=0)
    np.testing.assert_allclose(got.noisy, want.noisy, atol=LABEL_TOL, rtol=0)
    assert np.abs(got.noisy - got.ideal).max() > 1e-3   # the noise acts
    if name == "mbl_cut":
        ib_got, ib_want = td.dataset_imbalance(got), jd.dataset_imbalance(want)
        np.testing.assert_allclose(ib_got, ib_want, atol=LABEL_TOL, rtol=0)


def test_chunks_reproduce_the_whole_batch(monkeypatch):
    """Chunked labels equal the one-chunk labels at shots=None; sampled
    chunks draw from seed + 7·chunk."""
    ds = td.random_circuit_dataset(DEV, 3, 3, num_circuits=7, shots=None,
                                   seed=8, device="cpu")
    assert td._zq_chunk(3) == (1 << 30) // (8 << 6)
    monkeypatch.setattr(td, "_ZQ_DM_BYTES", 3 * (8 << 6))
    assert td._zq_chunk(3) == 3
    nm = td.noise_setting(DEV, "device")
    ideal, noisy = td._zq_labels(ds.circuits, DEV, nm, None, 8,
                                 device="cpu")
    np.testing.assert_allclose(ideal, ds.ideal, atol=1e-7, rtol=0)
    np.testing.assert_allclose(noisy, ds.noisy, atol=1e-7, rtol=0)
    _, s1 = td._zq_labels(ds.circuits, DEV, nm, 1000, 8, ideal=False,
                          device="cpu")
    _, s2 = td._zq_labels(ds.circuits[3:6], DEV, nm, 1000, 8 + 7,
                          ideal=False, device="cpu")
    np.testing.assert_array_equal(s1[3:6], s2)


def test_sampled_labels_within_five_sigma():
    kw = dict(num_circuits=12, steps_range=(1, 4), seed=9, device="cpu")
    exact = td.ising_dataset(DEV, shots=None, **kw)
    shots = 10000
    sampled = td.ising_dataset(DEV, shots=shots, ideal_shots=shots, **kw)
    for got, want in ((sampled.noisy, exact.noisy),
                      (sampled.ideal, exact.ideal)):
        sigma = np.sqrt(np.maximum(1.0 - want ** 2, 1e-4) / shots)
        assert np.all(np.abs(got - want) <= 5 * sigma)
        assert not np.array_equal(got, want)


def _pair(n=10, seed=4):
    """One ising dataset in both packages (the port's holds JAX's labels)."""
    want = jd.ising_dataset(JDEV, num_circuits=n, steps_range=(0, 5),
                            shots=None, seed=seed)
    got = td.LabeledDataset([Circuit.from_dict(c.to_dict())
                             for c in want.circuits], want.ideal.copy(),
                            want.noisy.copy(), want.meta)
    return got, want


def test_encoders_match_jax():
    got, want = _pair(12)
    for a, b in zip(tmit.encode_dataset(got, DEV),
                    jmit.encode_dataset(want, JDEV)):
        np.testing.assert_array_equal(a, b)
    for kw in (dict(stats_count=8), dict(stats_indices=[1, 5, 7, 9]),
               dict(standardize=False, max_nodes=64, max_edges=200)):
        a = tmit.graph_encode_dataset(got, DEV, **kw)
        b = jmit.graph_encode_dataset(want, JDEV, **kw)
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)


def test_zne_batch_twirled_matches_jax():
    """Folded and twirled circuits identical; the extrapolated values at
    shots=None ≤ 1e-5, under coherent noise."""
    got, want = _pair(3, seed=6)
    strat, jstrat = (ZNEStrategy(noise_factors=(1, 3), num_twirls=2),
                     JZNEStrategy(noise_factors=(1, 3), num_twirls=2))
    for ci, (c, jc) in enumerate(zip(got.circuits, want.circuits)):
        for nf in (1, 3):
            assert [x.to_dict() for x in strat.amplify_twirled(
                c, nf, seed=5 + ci)] == [x.to_dict() for x in
                                         jstrat.amplify_twirled(
                                             jc, nf, seed=5 + ci)]
    nm = td.noise_setting(DEV, "coherent", seed=7)
    jnm = jd.noise_setting(JDEV, "coherent", seed=7)
    z = tmit.zne_batch(got, DEV, strategy=strat, noise=nm, shots=None,
                       seed=5, device="cpu")
    jz = jmit.zne_batch(want, JDEV, strategy=jstrat, noise=jnm, shots=None,
                        seed=5)
    assert z.shape == want.ideal.shape
    np.testing.assert_allclose(z, jz, atol=LABEL_TOL, rtol=0)
    # num_twirls= overrides the strategy's
    z1 = tmit.zne_batch(got, DEV, noise=nm, shots=None, seed=5,
                        num_twirls=2, device="cpu")
    np.testing.assert_allclose(z1, z, atol=1e-12, rtol=0)


def test_linear_and_forest_arms_match_jax():
    got, want = _pair(20)
    lin = tmit.train_mitigation_model(LinearRegression(device="cpu"), got,
                                      DEV, seed=1, device="cpu")
    jlin = jmit.train_mitigation_model(JLinear(), want, JDEV, seed=1)
    assert lin["test_indices"] == jlin["test_indices"]
    for k in ("rmse_noisy", "rmse_mitigated", "rmse_per_qubit_noisy",
              "rmse_per_qubit_mitigated"):
        np.testing.assert_allclose(lin[k], jlin[k], atol=1e-5, rtol=0)
    rf = tmit.train_mitigation_model(
        RandomForestRegressor(20, random_state=2, device="cpu"), got, DEV,
        seed=1, device="cpu")
    jrf = jmit.train_mitigation_model(JForest(20, random_state=2), want,
                                      JDEV, seed=1)
    for a, b in zip(rf["model"]._stacked, jrf["model"]._stacked):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for k in ("rmse_noisy", "rmse_mitigated"):
        np.testing.assert_allclose(rf[k], jrf[k], atol=1e-6, rtol=0)
    # mimicry on the same ZNE values: the same forest both sides
    zv = jmit.zne_batch(want, JDEV, shots=None, seed=1)
    mim = tmit.train_zne_mimic(
        RandomForestRegressor(10, random_state=0, device="cpu"), got, DEV,
        zne_values=zv, seed=0, device="cpu")
    jmim = jmit.train_zne_mimic(JForest(10, random_state=0), want, JDEV,
                                zne_values=zv, seed=0)
    assert {k for k in jmim if k != "variables"} == \
        {k for k in mim if k != "state_dict"}
    for k in jmim:
        if k.startswith("rmse"):
            np.testing.assert_allclose(mim[k], jmim[k], atol=1e-6, rtol=0)
