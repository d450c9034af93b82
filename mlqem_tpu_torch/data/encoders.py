"""Feature encoders: circuits + calibration + expvals → model inputs.

The port's copy of ``mlqem_tpu/data/encoders.py`` (host numpy), quirks
included. Output-parity rebuilds of the reference's encoders:

* :func:`encode_data` — the 58-dim (FakeLima, 4q) flat feature vector of
  ``blackwater/library/learning/mlp.py:149-203``: 8 device-average
  calibration stats ×100, per-gate-type counts ×0.01, 40 rotation-angle bins
  (0.1π) ×0.01, noisy expvals, optional encoded measurement basis.
* :func:`encode_data_v2_ecr` — the device-independent hardware variant
  (``docs/tutorials/mlp.py:148-194``): gate set [2q|sx|x|id|rz], 0.025π bins
  (160), no device block.
* :func:`encode_pauli_sum_op` — [coeff, per-qubit I/Z/Y/X one-hots]
  (``data/utils.py:447-474``).
* counts-domain estimators ``cal_z_exp`` / ``cal_all_z_exp`` /
  ``calc_imbalance`` (``mbd_utils.py:328-411``).

Each encoder has a batch form producing numpy arrays ready for the models.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from ..circuits.circuit import Circuit
from ..circuits.observables import PauliSum


# ---------------------------------------------------------------------------
# Calibration-stat extraction (reference quirks preserved)
# ---------------------------------------------------------------------------
def recursive_dict_loop(my_dict, parent_key=None, out=None,
                        target_key1=None, target_key2=None):
    """Collect leaf values where the parent key contains ``target_key1`` and
    the leaf key equals ``target_key2``.

    Exact behavioral parity with ``mlp.py:136-145`` — including two quirks:
    substring matching makes the 'x' gate-error average include *cx and sx*
    errors as well, and the truthiness test on ``parent_key`` silently drops
    leaves under the integer key 0, so qubit 0's t1/t2/readout_error never
    enter the device-stat averages.
    """
    if out is None:
        out = []
    for key, val in my_dict.items():
        if isinstance(val, dict):
            recursive_dict_loop(val, key, out, target_key1, target_key2)
        else:
            if parent_key and target_key1 in str(parent_key) \
                    and key == target_key2:
                out += [val]
    return out or 0.0


def device_stat_vector(properties: dict) -> np.ndarray:
    """The 8 device-average stats ×100 (``mlp.py:158-166``)."""
    def mean(k1, k2):
        vals = recursive_dict_loop(properties, out=[], target_key1=k1,
                                   target_key2=k2)
        return float(np.mean(vals)) if vals != 0.0 else 0.0

    vec = [
        mean("cx", "gate_error"),
        mean("id", "gate_error"),
        mean("sx", "gate_error"),
        mean("x", "gate_error"),
        mean("rz", "gate_error"),
        mean("", "readout_error"),
        mean("", "t1"),
        mean("", "t2"),
    ]
    return np.asarray(vec, dtype=np.float32) * 100.0


def count_gates_by_rotation_angle(circuit: Circuit, bin_size: float
                                  ) -> np.ndarray:
    """Histogram of rx/ry/rz angles over [-2π, 2π] (``mlp.py:124-133``)."""
    angles = circuit.rotation_angles()
    bin_edges = np.arange(-2 * np.pi, 2 * np.pi + bin_size, bin_size)
    counts, _ = np.histogram(angles, bins=bin_edges)
    return counts


def encode_pauli_sum_op(op: Union[PauliSum, str]) -> List[List[float]]:
    """[coeff, I/Z/Y/X one-hots per qubit] rows (``data/utils.py:447-474``).

    One-hot order matches the reference mapping exactly:
    I→[1,0,0,0], Z→[0,1,0,0], Y→[0,0,1,0], X→[0,0,0,1].
    """
    if isinstance(op, str):
        op = PauliSum(op)
    mapping = {"X": [0, 0, 0, 1], "Y": [0, 0, 1, 0],
               "Z": [0, 1, 0, 0], "I": [1, 0, 0, 0]}
    rows = []
    for term in op.terms:
        row = [float(np.real(term.coeff))]
        for ch in term.pauli:
            row += mapping[ch]
        rows.append(row)
    return rows


def _normalize_noisy(noisy_exp_vals):
    if isinstance(noisy_exp_vals[0], (list, tuple, np.ndarray)) \
            and len(noisy_exp_vals[0]) == 1:
        return [float(x[0]) for x in noisy_exp_vals]
    return noisy_exp_vals


def encode_data(circuits: Sequence[Circuit], properties: dict,
                ideal_exp_vals, noisy_exp_vals, num_qubits: int,
                meas_bases: Optional[List[List[float]]] = None):
    """Flat feature matrix, ``mlp.py:149-203`` output parity.

    Returns (X, y) float32 numpy arrays. Feature layout:
    [8 device stats ×100 | per-gate counts ×0.01 | 40 angle bins ×0.01 |
     noisy expvals (num_qubits) | encoded meas basis].
    """
    noisy_exp_vals = _normalize_noisy(noisy_exp_vals)
    # sorting pins the per-gate-count column order (parity quirk: the
    # feature layout depends on the lexicographic order of gates_set)
    gates_set = sorted(properties["gates_set"])
    if meas_bases is None:
        meas_bases = [[]]
    vec = device_stat_vector(properties)
    bin_size = 0.1 * np.pi
    num_angle_bins = int(np.ceil(4 * np.pi / bin_size))
    width = (len(vec) + len(gates_set) + num_angle_bins + num_qubits
             + len(meas_bases[0]))
    X = np.zeros((len(circuits), width), dtype=np.float32)
    X[:, :len(vec)] = vec[None, :]
    g0 = len(vec)
    a0 = g0 + len(gates_set)
    e0 = a0 + num_angle_bins
    m0 = e0 + num_qubits
    for i, circ in enumerate(circuits):
        counts = circ.count_ops()
        X[i, g0:a0] = np.array([counts.get(k, 0) for k in gates_set],
                               dtype=np.float32) * 0.01
        X[i, a0:e0] = count_gates_by_rotation_angle(
            circ, bin_size).astype(np.float32) * 0.01
        if num_qubits > 1:
            assert len(noisy_exp_vals[i]) == num_qubits
        X[i, e0:m0] = np.asarray(noisy_exp_vals[i], dtype=np.float32)
    if meas_bases != [[]]:
        assert len(meas_bases) == len(circuits)
        for i, basis in enumerate(meas_bases):
            X[i, m0:] = np.asarray(basis, dtype=np.float32)
    y = np.asarray(ideal_exp_vals, dtype=np.float32)
    return X, y


def encode_data_v2_ecr(circuits: Sequence[Circuit], ideal_exp_vals,
                       noisy_exp_vals, obs_size: int,
                       meas_bases: Optional[List[List[float]]] = None,
                       two_q_gate: str = "ecr"):
    """Device-independent variant (``docs/tutorials/mlp.py:148-194``):
    gate set [2q, sx, x, id, rz], 0.025π angle bins (160), no device block."""
    noisy_exp_vals = _normalize_noisy(noisy_exp_vals)
    if meas_bases is None:
        meas_bases = [[]]
    gates_set = [two_q_gate] + ["sx", "x", "id", "rz"]
    bin_size = 0.025 * np.pi
    num_angle_bins = int(np.ceil(4 * np.pi / bin_size))
    width = (len(gates_set) + num_angle_bins + obs_size + len(meas_bases[0]))
    X = np.zeros((len(circuits), width), dtype=np.float32)
    a0 = len(gates_set)
    e0 = a0 + num_angle_bins
    m0 = e0 + obs_size
    for i, circ in enumerate(circuits):
        counts = circ.count_ops()
        X[i, :a0] = np.array([counts.get(k, 0) for k in gates_set],
                             dtype=np.float32) * 0.01
        X[i, a0:e0] = count_gates_by_rotation_angle(
            circ, bin_size).astype(np.float32) * 0.01
        if obs_size > 1:
            assert len(noisy_exp_vals[i]) == obs_size
        X[i, e0:m0] = np.asarray(noisy_exp_vals[i], dtype=np.float32)
    if meas_bases != [[]]:
        assert len(meas_bases) == len(circuits)
        for i, basis in enumerate(meas_bases):
            X[i, m0:] = np.asarray(basis, dtype=np.float32)
    y = np.asarray(ideal_exp_vals, dtype=np.float32)
    return X, y


# ---------------------------------------------------------------------------
# Counts-domain observable estimators
# ---------------------------------------------------------------------------
def cal_z_exp(counts: Dict[str, int]) -> np.ndarray:
    """Per-bit 'z expectation' from counts, ``mbd_utils.py:328-350`` parity.

    NOTE the reference convention: the returned value is
    P(bit=1) − P(bit=0) per *string position* (leftmost position first),
    i.e. the NEGATIVE of the physics ⟨Z⟩, ordered from highest qubit down.
    """
    shots = sum(counts.values())
    num_bits = len(next(iter(counts)))
    count_pos = np.zeros(num_bits)
    for key, val in counts.items():
        count_pos += val * np.array(list(key), dtype=int)
    count_neg = shots - count_pos
    return (count_pos - count_neg) / shots


def cal_all_z_exp(counts: Dict[str, int],
                  marginal_over: Optional[Sequence[int]] = None) -> float:
    """Global ⟨Z…Z⟩ from counts with optional marginalization
    (``mbd_utils.py:386-411``). ``marginal_over`` lists qubit indices
    (qiskit order: index 0 = rightmost bit) to keep."""
    if marginal_over is not None:
        counts = marginal_counts(counts, marginal_over)
    shots = sum(counts.values())
    acc = 0.0
    for key, val in counts.items():
        acc += ((-1) ** key.count("1")) * val
    return acc / shots


def marginal_counts(counts: Dict[str, int],
                    indices: Sequence[int]) -> Dict[str, int]:
    """Marginalize counts onto the given qubit indices (qiskit semantics:
    index 0 = rightmost character)."""
    out: Dict[str, int] = {}
    for key, val in counts.items():
        n = len(key)
        sub = "".join(key[n - 1 - q] for q in sorted(indices, reverse=True))
        out[sub] = out.get(sub, 0) + val
    return out


def calc_imbalance(single_z_dataset, even_qubits, odd_qubits) -> np.ndarray:
    """MBL charge imbalance from per-qubit z expectations
    (``mbd_utils.py:353-383``): densities n_i = (1 − z_i)/2,
    imbalance = (N_odd − N_even)/(N_odd + N_even)."""
    density = (1 - np.asarray(single_z_dataset, dtype=np.float64)) / 2
    n_odd = density[:, np.asarray(odd_qubits, dtype=int)].sum(axis=1)
    n_even = density[:, np.asarray(even_qubits, dtype=int)].sum(axis=1)
    return (n_odd - n_even) / (n_even + n_odd)


def counts_to_feature_vector(counts: Dict[str, int],
                             num_qubits: int) -> List[float]:
    """Counts → full 2**n probability vector (``data/utils.py:178-195``)."""
    fmt = "{:0" + str(num_qubits) + "b}"
    allp = {fmt.format(i): 0 for i in range(2 ** num_qubits)}
    shots = sum(counts.values())
    merged = {**allp, **counts}
    return [float(v) / shots for v in merged.values()]
