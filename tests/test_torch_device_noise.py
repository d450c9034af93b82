"""Port vs JAX package: gates, channels, device models, noise tables."""
import numpy as np
import pytest

import mlqem_tpu.circuits.gates as jgates
import mlqem_tpu.ops.channels as jchannels
import mlqem_tpu.ops.trajectory as jtraj
from mlqem_tpu.device.noise import NoiseModel as JNoiseModel
from mlqem_tpu.device.registry import configurable_device as j_configurable
from mlqem_tpu.device.registry import get_device as j_get_device

import mlqem_tpu_torch.circuits.gates as tgates
import mlqem_tpu_torch.ops.channels as tchannels
import mlqem_tpu_torch.ops.trajectory as ttraj
from mlqem_tpu_torch import NoiseModel, configurable_device, get_device
from mlqem_tpu_torch.convert import device_from_jax_dict
from mlqem_tpu_torch.device.registry import list_devices

from port_fixtures import one_torch_thread  # noqa: F401

DEVICES = [("configurable_10", lambda m: m.configurable_device(10, seed=0)),
           ("fake_lima", lambda m: m.get_device("fake_lima"))]


class _Port:
    configurable_device = staticmethod(configurable_device)
    get_device = staticmethod(get_device)


class _Jax:
    configurable_device = staticmethod(j_configurable)
    get_device = staticmethod(j_get_device)


@pytest.mark.parametrize("name,make", DEVICES, ids=[d[0] for d in DEVICES])
def test_device_to_dict_equal(name, make):
    assert make(_Port).to_dict() == make(_Jax).to_dict()


@pytest.mark.parametrize("name", ["fake_montreal", "fake_belem",
                                  "fake_guadalupe", "fake_sherbrooke"])
def test_registry_devices_equal(name):
    assert get_device(name).to_dict() == j_get_device(name).to_dict()


def test_list_devices_equal():
    from mlqem_tpu.device.registry import list_devices as j_list

    assert list_devices() == j_list()


@pytest.mark.parametrize("name,make", DEVICES, ids=[d[0] for d in DEVICES])
def test_noise_model_from_device(name, make):
    port = NoiseModel.from_device(make(_Port))
    ref = JNoiseModel.from_device(make(_Jax))
    assert set(port.local_channels) == set(ref.local_channels)
    dev = make(_Port)
    pairs = sorted({(a, b) for a, b in dev.coupling_map})
    assert pairs
    for pair in pairs:
        got = port.channel_for("cx", pair)
        want = ref.channel_for("cx", pair)
        assert len(got.kraus) == len(want.kraus)
        for kg, kw in zip(got.kraus, want.kraus):
            np.testing.assert_allclose(kg, kw, atol=1e-12, rtol=0)
    np.testing.assert_allclose(port.readout, ref.readout, atol=1e-12,
                               rtol=0)


@pytest.mark.parametrize("name,make", DEVICES, ids=[d[0] for d in DEVICES])
def test_pauli_channel_probs_and_composition(name, make):
    port = NoiseModel.from_device(make(_Port))
    ref = JNoiseModel.from_device(make(_Jax))
    for (gate, qubits), chan in sorted(ref.local_channels.items()):
        if gate != "cx":
            continue
        p_ref = jtraj.pauli_channel_probs(chan)
        p_got = ttraj.pauli_channel_probs(port.channel_for(gate, qubits))
        np.testing.assert_allclose(p_got, p_ref, atol=1e-7, rtol=0)
        np.testing.assert_allclose(
            ttraj.compose_pauli_channel(p_got, 3),
            jtraj.compose_pauli_channel(p_ref, 3), atol=1e-7, rtol=0)


def test_walsh_and_pauli_tables_equal():
    np.testing.assert_array_equal(ttraj.walsh_sign_matrix(),
                                  jtraj.walsh_sign_matrix())
    np.testing.assert_array_equal(ttraj.PAULI_4X4, jtraj.PAULI_4X4)


def test_device_from_jax_dict_round_trips():
    for ref in (j_configurable(10, seed=0), j_get_device("fake_lima")):
        d = ref.to_dict()
        port = device_from_jax_dict(d)
        assert port.to_dict() == d
        assert port.properties() == ref.properties()


@pytest.mark.parametrize("name", [g for g in jgates.GATE_NAMES])
def test_gate_unitaries_equal(name, rng):
    params = rng.uniform(-np.pi, np.pi, size=3)
    np.testing.assert_array_equal(tgates.gate_unitary_4x4(name, params),
                                  jgates.gate_unitary_4x4(name, params))


def test_channel_constructors_equal():
    cases = [
        ("depolarizing_channel", (0.03, 2)),
        ("depolarizing_channel", (0.01, 1)),
        ("thermal_relaxation_channel", (1.1e-4, 0.9e-4, 4e-7)),
        ("thermal_relaxation_channel", (1.1e-4, 0.9e-4, 4e-7, 0.05)),
        ("amplitude_damping_channel", (0.07,)),
        ("phase_damping_channel", (0.05,)),
        ("coherent_overrotation_cx", (0.3,)),
        ("pauli_channel", ([("IX", 0.1), ("ZZ", 0.2), ("II", 0.7)],)),
    ]
    for fn, args in cases:
        got = getattr(tchannels, fn)(*args)
        want = getattr(jchannels, fn)(*args)
        for kg, kw in zip(got.kraus, want.kraus, strict=True):
            np.testing.assert_array_equal(kg, kw)
    relax = tchannels.thermal_relaxation_channel(1e-4, 8e-5, 4e-7)
    jrelax = jchannels.thermal_relaxation_channel(1e-4, 8e-5, 4e-7)
    assert (tchannels.depol_param_for_target_error(0.01, relax, 1)
            == jchannels.depol_param_for_target_error(0.01, jrelax, 1))
    np.testing.assert_array_equal(tchannels.readout_confusion(0.02, 0.03),
                                  jchannels.readout_confusion(0.02, 0.03))


# -- the closed-form twirl against the JAX package's PTM loop ---------------

def _forward_only(nm):
    """A copy keeping one direction of each CX pair, so that channel_for
    builds the other by SWAP conjugation."""
    out = nm.copy()
    out.local_channels = {(g, q): c for (g, q), c in nm.local_channels.items()
                          if g != "cx" or q[0] < q[1]}
    return out


TWIRL_MODELS = {
    "configurable_10": lambda: NoiseModel.from_device(
        configurable_device(10, seed=0)),
    "configurable_100_x2.5": lambda: NoiseModel.from_device(
        configurable_device(100, seed=1), scale=2.5),
    "fake_lima": lambda: NoiseModel.from_device(get_device("fake_lima")),
    "fake_lima_forward_only": lambda: _forward_only(
        NoiseModel.from_device(get_device("fake_lima"))),
}


def _ptm_loop(chan):
    """The JAX package's twirl of the port's channel."""
    return jtraj.pauli_channel_probs(jchannels.Channel(list(chan.kraus)))


@pytest.mark.parametrize("name", list(TWIRL_MODELS))
def test_pauli_channel_probs_closed_form_cx(name):
    nm = TWIRL_MODELS[name]()
    pairs = sorted({tuple(sorted(q)) for g, q in nm.local_channels
                    if g == "cx"})[:20]
    assert pairs
    for a, b in pairs:
        for qubits in ((a, b), (b, a)):
            chan = nm.channel_for("cx", qubits)
            np.testing.assert_allclose(ttraj.pauli_channel_probs(chan),
                                       _ptm_loop(chan), atol=1e-12, rtol=0)


@pytest.mark.parametrize("chan", [
    tchannels.thermal_relaxation_channel(1.1e-4, 0.9e-4, 4e-7),
    tchannels.amplitude_damping_channel(0.07).compose(
        tchannels.depolarizing_channel(0.01, 1)),
], ids=["thermal", "amp_damp_depol"])
def test_pauli_channel_probs_closed_form_1q(chan):
    assert chan.dim == 2
    got = ttraj.pauli_channel_probs(chan)
    np.testing.assert_allclose(got, _ptm_loop(chan), atol=1e-12, rtol=0)
    np.testing.assert_array_equal(
        got, ttraj.pauli_channel_probs(chan.expand_to_2q(0)))


@pytest.mark.parametrize("kraus", [
    [0.9 * k for k in tchannels.depolarizing_channel(0.03, 2).kraus],
    [np.diag([1.0, 0.7, 0.5, 0.2]).astype(np.complex128)],
    [np.zeros((4, 4), np.complex128)],
], ids=["scaled_depol", "one_diagonal", "zero"])
def test_pauli_channel_probs_closed_form_not_trace_preserving(kraus):
    chan = tchannels.Channel(kraus)
    got = ttraj.pauli_channel_probs(chan)
    np.testing.assert_allclose(got, _ptm_loop(chan), atol=1e-12, rtol=0)
    assert got.min() >= 0.0
    assert got.sum() == pytest.approx(1.0 if np.any(kraus[0]) else 0.0,
                                      abs=1e-12)


@pytest.mark.parametrize("num_qubits,seed,scale",
                         [(10, 0, 1.0), (100, 1, 2.5)],
                         ids=["kicked-ising-10q", "lightcone-100q-demo1"])
def test_pauli_channel_probs_float32_bits(num_qubits, seed, scale):
    """The benchmark calibrations' float32 tables equal the PTM loop's bit
    for bit, so the Paulis drawn for a seed do not change."""
    nm = NoiseModel.from_device(configurable_device(num_qubits, seed=seed),
                                scale=scale)
    chans = [c for (g, _), c in sorted(nm.local_channels.items())
             if g == "cx"]
    assert len(chans) == 2 * (num_qubits - 1)
    got = np.stack([ttraj.pauli_channel_probs(c) for c in chans])
    want = np.stack([_ptm_loop(c) for c in chans])
    np.testing.assert_array_equal(got.astype(np.float32),
                                  want.astype(np.float32))


def test_kicked_engine_bond_probs_equal_jax():
    """The ZNE cell's engine at noise_scale 3: the twirled, composed bond
    table equals the JAX engine's."""
    from mlqem_tpu.ops.kicked_ising import KickedIsingEngine as JEngine
    from mlqem_tpu_torch.ops.kicked_ising import KickedIsingEngine

    got = KickedIsingEngine(configurable_device(10, seed=0), nq=10, steps=4,
                            device="cpu", noise_scale=3).tables.bond_probs
    want = JEngine(j_configurable(10, seed=0), nq=10, steps=4,
                   noise_scale=3)._bond_probs
    np.testing.assert_array_equal(got.numpy(), want)


def test_lightcone_window_probs_equal_jax():
    """demo1's noise (×2.5) on the window of qubit 54 (w 21, 20 bonds)."""
    from mlqem_tpu.ops.lightcone import LightconeIsing as JLightcone
    from mlqem_tpu_torch.ops.lightcone import LightconeIsing

    dev, jdev = configurable_device(100, seed=1), j_configurable(100, seed=1)
    got = LightconeIsing(dev, nq=100, steps=10, device="cpu",
                         noise_model=NoiseModel.from_device(dev, scale=2.5)
                         ).window_tables(54)
    want = JLightcone(jdev, nq=100, steps=10,
                      noise_model=JNoiseModel.from_device(jdev, scale=2.5)
                      )._window_tables(54)
    assert got["bonds"] == want["bonds"] and len(got["bonds"]) == 20
    np.testing.assert_array_equal(got["probs"], want["probs"])
