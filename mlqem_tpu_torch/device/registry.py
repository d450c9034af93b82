"""Fake-device registry.

The same device models as the JAX package's registry: Lima and Montreal
carry real calibration snapshots, read in place from the JAX package's
fixture files (by path, without importing that package); the others are
deterministic synthetic calibrations with the right topology and basis.
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from .model import DeviceModel, GateProps, QubitProps

_FIXTURE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "mlqem_tpu", "device", "fixtures")


def _line_coupling(n: int) -> List[Tuple[int, int]]:
    out = []
    for q in range(n - 1):
        out += [(q, q + 1), (q + 1, q)]
    return out


def _t_coupling() -> List[Tuple[int, int]]:
    """The 5q 'T' topology of Lima/Belem/Quito."""
    pairs = [(0, 1), (1, 2), (1, 3), (3, 4)]
    out = []
    for a, b in pairs:
        out += [(a, b), (b, a)]
    return out


def heavy_hex_coupling(num_rows: int = 7, row_len: int = 15
                       ) -> Tuple[int, List[Tuple[int, int]]]:
    """Eagle-style heavy-hex lattice (127 qubits for the default shape)."""
    rows: List[List[int]] = []
    nxt = 0
    lens = [row_len - 1] + [row_len] * (num_rows - 2) + [row_len - 1]
    conn_groups: List[List[int]] = []
    for r, ln in enumerate(lens):
        rows.append(list(range(nxt, nxt + ln)))
        nxt += ln
        if r < num_rows - 1:
            conn_groups.append(list(range(nxt, nxt + 4)))
            nxt += 4
    pairs: List[Tuple[int, int]] = []
    for row in rows:
        for a, b in zip(row, row[1:]):
            pairs.append((a, b))
    for g, conns in enumerate(conn_groups):
        top_cols = [0, 4, 8, 12] if g % 2 == 0 else [2, 6, 10, 14]
        bot_cols = [2, 6, 10, 14] if g % 2 == 0 else [0, 4, 8, 12]
        top, bot = rows[g], rows[g + 1]
        for c, tc, bc in zip(conns, top_cols, bot_cols):
            pairs.append((top[min(tc, len(top) - 1)], c))
            pairs.append((c, bot[min(bc, len(bot) - 1)]))
    out = []
    for a, b in pairs:
        out += [(a, b), (b, a)]
    return nxt, out


def synthesize_device(name: str, num_qubits: int,
                      coupling_map: List[Tuple[int, int]],
                      two_q_gate: str = "cx",
                      seed: int = 7,
                      t1_mean: float = 1.2e-4,
                      cx_err_mean: float = 7e-3,
                      sx_err_mean: float = 2.5e-4,
                      readout_err_mean: float = 1.5e-2) -> DeviceModel:
    """Deterministic synthetic calibration with realistic magnitudes."""
    rng = np.random.default_rng(seed)
    qubits = []
    for _ in range(num_qubits):
        t1 = float(t1_mean * rng.lognormal(0.0, 0.35))
        t2 = float(min(t1 * rng.uniform(0.6, 1.8), 2 * t1))
        qubits.append(QubitProps(
            t1=t1, t2=t2,
            readout_error=float(readout_err_mean * rng.lognormal(0, 0.4))))
    gates: Dict[str, GateProps] = {}
    directed = {(a, b) for a, b in coupling_map}
    for a, b in sorted(directed):
        gates[f"{two_q_gate}_{a}_{b}"] = GateProps(
            gate_error=float(cx_err_mean * rng.lognormal(0, 0.4)),
            gate_length=float(rng.uniform(3.0e-7, 5.5e-7)))
    for q in range(num_qubits):
        e = float(sx_err_mean * rng.lognormal(0, 0.4))
        for g in ("sx", "x", "id"):
            gates[f"{g}_{q}"] = GateProps(e, 3.55e-8)
        gates[f"rz_{q}"] = GateProps(0.0, 0.0)
        # keep gates_set congruent with the Lima/Montreal snapshots so flat
        # feature vectors share one width across devices (transfer learning)
        gates[f"reset_{q}"] = GateProps(0.0, 5.8e-6)
    basis = [two_q_gate, "id", "rz", "sx", "x"]
    return DeviceModel(name, num_qubits, basis, coupling_map, qubits, gates)


def get_device(name: str) -> DeviceModel:
    """A fresh :class:`DeviceModel` for a registered device name."""
    fixture = os.path.join(_FIXTURE_DIR, f"{name}.json")
    if os.path.exists(fixture):
        return DeviceModel.from_json(fixture)
    if name == "fake_belem":
        return synthesize_device(name, 5, _t_coupling(), seed=11,
                                 cx_err_mean=9e-3)
    if name == "fake_quito":
        return synthesize_device(name, 5, _t_coupling(), seed=13)
    if name == "fake_guadalupe":
        # 16q heavy-hex fragment (ring of 12 with 4 spurs)
        pairs = [(0, 1), (1, 2), (2, 3), (3, 5), (5, 8), (8, 11), (11, 14),
                 (14, 13), (13, 12), (12, 10), (10, 7), (7, 4), (4, 1),
                 (7, 6), (8, 9), (12, 15)]
        cm = []
        for a, b in pairs:
            cm += [(a, b), (b, a)]
        return synthesize_device(name, 16, cm, seed=17)
    if name == "fake_sherbrooke":
        n, cm = heavy_hex_coupling()
        return synthesize_device(name, n, cm, two_q_gate="ecr", seed=19,
                                 t1_mean=2.6e-4, cx_err_mean=8e-3,
                                 sx_err_mean=2.2e-4, readout_err_mean=1.3e-2)
    if name == "fake_washington":
        n, cm = heavy_hex_coupling()
        return synthesize_device(name, n, cm, seed=23, t1_mean=1.0e-4)
    if name == "fake_brisbane":
        n, cm = heavy_hex_coupling()
        return synthesize_device(name, n, cm, two_q_gate="ecr", seed=29,
                                 t1_mean=2.3e-4)
    raise KeyError(f"unknown device {name!r}; known: {list_devices()}")


def list_devices() -> List[str]:
    fixtures = [f[:-5] for f in os.listdir(_FIXTURE_DIR)
                if f.endswith(".json")]
    return sorted(set(fixtures) | {
        "fake_belem", "fake_quito", "fake_guadalupe", "fake_sherbrooke",
        "fake_washington", "fake_brisbane"})


def configurable_device(num_qubits: int, seed: int = 0,
                        two_q_gate: str = "cx",
                        topology: str = "line") -> DeviceModel:
    """ConfigurableFakeBackend parity (``06_scalability.ipynb`` sweeps
    n_qubits ∈ {5, 20, 50, 100, 200, 400})."""
    if topology == "line":
        cm = _line_coupling(num_qubits)
    elif topology == "ring":
        cm = _line_coupling(num_qubits) + [(num_qubits - 1, 0),
                                           (0, num_qubits - 1)]
    else:
        raise ValueError(f"unknown topology {topology}")
    return synthesize_device(f"configurable_{num_qubits}q", num_qubits, cm,
                             two_q_gate=two_q_gate, seed=seed)
