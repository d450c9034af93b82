"""ctypes bindings for the native host encoder library, with numpy
fallbacks.

Counterpart of ``mlqem_tpu/utils/native.py``. It binds the JAX package's
``native/encoders.cpp`` by path, built with the host compiler into the
port's ``_build/`` on first use (:func:`..utils.build.build_host_library`).
Each entry point has a plain numpy version (``*_reference``), which runs
where the machine has no compiler: the native path only makes host-side
feature extraction for large heterogeneous circuit datasets faster. No
device is involved.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import List, Optional, Tuple

import numpy as np

from ..circuits.gates import ROTATION_GATES
from ..data.encoders import _normalize_noisy, device_stat_vector
from .build import build_host_library

SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "native", "encoders.cpp")


@functools.lru_cache(maxsize=1)
def load_native() -> Optional[ctypes.CDLL]:
    """Build (once) and load the native library; None without a host
    compiler or without the source."""
    if not os.path.exists(SOURCE):
        return None
    lib = build_host_library(SOURCE, "mlqem_native")
    if lib is None:
        return None
    ip = ctypes.POINTER(ctypes.c_int)
    lp = ctypes.POINTER(ctypes.c_long)
    dp = ctypes.POINTER(ctypes.c_double)
    up = ctypes.POINTER(ctypes.c_ubyte)
    lib.count_gates_batch.argtypes = [ip, lp, ctypes.c_long, ctypes.c_int,
                                      ip]
    lib.angle_hist_batch.argtypes = [dp, up, lp, ctypes.c_long,
                                     ctypes.c_int, ip]
    lib.wire_edges_batch.argtypes = [ip, lp, ctypes.c_long, ctypes.c_int,
                                     ip, ip, lp, lp, ip]
    for fn in (lib.count_gates_batch, lib.angle_hist_batch,
               lib.wire_edges_batch):
        fn.restype = None
    return lib


def _ptr(a: np.ndarray, dtype, ctype):
    if a.dtype != dtype or not a.flags["C_CONTIGUOUS"]:
        raise ValueError(f"native buffer must be C-contiguous {dtype}, got "
                         f"{a.dtype}")
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# ---------------------------------------------------------------------------
# flattening + dispatch
# ---------------------------------------------------------------------------
def flatten_circuits(circuits, kind_index) -> dict:
    """Flatten circuits into the native layout.

    kind_index: dict gate-name → vocabulary index (-1 = not counted).
    """
    kinds: List[int] = []
    qubits: List[Tuple[int, int]] = []
    params: List[float] = []
    is_rot: List[int] = []
    offsets = [0]
    max_q = 1
    for qc in circuits:
        for op in qc.ops:
            kinds.append(kind_index.get(op.name, -1))
            q0 = op.qubits[0] if op.qubits else 0
            q1 = op.qubits[1] if len(op.qubits) > 1 else -1
            qubits.append((q0, q1))
            rot = (op.name in ROTATION_GATES and len(op.qubits) == 1
                   and op.params and isinstance(op.params[0], float))
            params.append(float(op.params[0]) if rot else 0.0)
            is_rot.append(1 if rot else 0)
        offsets.append(len(kinds))
        max_q = max(max_q, qc.num_qubits)
    return {
        "kinds": np.asarray(kinds, np.int32),
        "qubits": np.asarray(qubits, np.int32).reshape(-1, 2),
        "params": np.asarray(params, np.float64),
        "is_rot": np.asarray(is_rot, np.uint8),
        "offsets": np.asarray(offsets, np.int64),
        "max_qubits": max_q,
    }


def count_gates_batch_reference(flat: dict, n_kinds: int) -> np.ndarray:
    """[n_circuits, n_kinds] gate-type counts (numpy)."""
    offs = flat["offsets"]
    out = np.zeros((offs.shape[0] - 1, n_kinds), np.int32)
    for c in range(out.shape[0]):
        seg = flat["kinds"][offs[c]:offs[c + 1]]
        seg = seg[(seg >= 0) & (seg < n_kinds)]
        np.add.at(out[c], seg, 1)
    return out


def count_gates_batch(flat: dict, n_kinds: int) -> np.ndarray:
    """[n_circuits, n_kinds] gate-type counts (native or numpy)."""
    lib = load_native()
    if lib is None:
        return count_gates_batch_reference(flat, n_kinds)
    n_c = flat["offsets"].shape[0] - 1
    out = np.zeros((n_c, n_kinds), np.int32)
    lib.count_gates_batch(_ptr(flat["kinds"], np.int32, ctypes.c_int),
                          _ptr(flat["offsets"], np.int64, ctypes.c_long),
                          n_c, n_kinds, _ptr(out, np.int32, ctypes.c_int))
    return out


def angle_hist_batch_reference(flat: dict, n_bins: int) -> np.ndarray:
    """[n_circuits, n_bins] rotation-angle histograms over [-2π, 2π]
    (numpy)."""
    offs = flat["offsets"]
    out = np.zeros((offs.shape[0] - 1, n_bins), np.int32)
    edges = np.linspace(-2 * np.pi, 2 * np.pi, n_bins + 1)
    for c in range(out.shape[0]):
        sel = flat["is_rot"][offs[c]:offs[c + 1]].astype(bool)
        angles = flat["params"][offs[c]:offs[c + 1]][sel]
        out[c], _ = np.histogram(angles, bins=edges)
    return out


def angle_hist_batch(flat: dict, n_bins: int) -> np.ndarray:
    """[n_circuits, n_bins] rotation-angle histograms over [-2π, 2π]
    (native or numpy)."""
    lib = load_native()
    if lib is None:
        return angle_hist_batch_reference(flat, n_bins)
    n_c = flat["offsets"].shape[0] - 1
    out = np.zeros((n_c, n_bins), np.int32)
    lib.angle_hist_batch(_ptr(flat["params"], np.float64, ctypes.c_double),
                         _ptr(flat["is_rot"], np.uint8, ctypes.c_ubyte),
                         _ptr(flat["offsets"], np.int64, ctypes.c_long),
                         n_c, n_bins, _ptr(out, np.int32, ctypes.c_int))
    return out


def fast_encode_data(circuits, properties: dict, ideal_exp_vals,
                     noisy_exp_vals, num_qubits: int, meas_bases=None):
    """Drop-in for :func:`..data.encoders.encode_data` (identical output,
    the hot loops batched through the native library)."""
    noisy_exp_vals = _normalize_noisy(noisy_exp_vals)
    gates_set = sorted(properties["gates_set"])
    if meas_bases is None:
        meas_bases = [[]]
    vec = device_stat_vector(properties)
    n_bins = 40
    width = (len(vec) + len(gates_set) + n_bins + num_qubits
             + len(meas_bases[0]))
    X = np.zeros((len(circuits), width), np.float32)
    X[:, :len(vec)] = vec[None, :]
    kind_index = {g: i for i, g in enumerate(gates_set)}
    flat = flatten_circuits(circuits, kind_index)
    g0 = len(vec)
    a0 = g0 + len(gates_set)
    e0 = a0 + n_bins
    m0 = e0 + num_qubits
    X[:, g0:a0] = count_gates_batch(flat, len(gates_set)) * 0.01
    X[:, a0:e0] = angle_hist_batch(flat, n_bins) * 0.01
    X[:, e0:m0] = np.asarray(noisy_exp_vals, np.float32).reshape(
        len(circuits), num_qubits)
    if meas_bases != [[]]:
        X[:, m0:] = np.asarray(meas_bases, np.float32)
    y = np.asarray(ideal_exp_vals, np.float32)
    return X, y


def wire_edges_batch_reference(flat: dict) -> List[np.ndarray]:
    """Per-circuit op→op wire edge lists: [2, n_edges] int32 each
    (numpy)."""
    offs = flat["offsets"]
    out = []
    for c in range(offs.shape[0] - 1):
        last: dict = {}
        es, ed = [], []
        for local, i in enumerate(range(offs[c], offs[c + 1])):
            q0, q1 = flat["qubits"][i]
            for q in (q0, q1):
                if q < 0:
                    continue
                if q in last:
                    es.append(last[q])
                    ed.append(local)
                last[q] = local
        out.append(np.asarray([es, ed], np.int32).reshape(2, -1))
    return out


def wire_edges_batch(flat: dict) -> List[np.ndarray]:
    """Per-circuit op→op wire edge lists: [2, n_edges] int32 each (native
    or numpy).

    NOTE: covers ops with ≤ 2 qubit operands (the simulator vocabulary);
    the canonical graph encoder (``data/graph.py``) remains the parity path
    for circuits containing all-qubit barriers."""
    lib = load_native()
    if lib is None:
        return wire_edges_batch_reference(flat)
    offs = flat["offsets"]
    n_c = offs.shape[0] - 1
    cap_per = 2 * np.diff(offs)
    edge_offsets = np.zeros(n_c, np.int64)
    np.cumsum(cap_per[:-1], out=edge_offsets[1:])
    total = int(cap_per.sum())
    src = np.zeros(total, np.int32)
    dst = np.zeros(total, np.int32)
    counts = np.zeros(n_c, np.int64)
    scratch = np.zeros(flat["max_qubits"], np.int32)
    lib.wire_edges_batch(_ptr(flat["qubits"], np.int32, ctypes.c_int),
                         _ptr(offs, np.int64, ctypes.c_long), n_c,
                         flat["max_qubits"],
                         _ptr(src, np.int32, ctypes.c_int),
                         _ptr(dst, np.int32, ctypes.c_int),
                         _ptr(edge_offsets, np.int64, ctypes.c_long),
                         _ptr(counts, np.int64, ctypes.c_long),
                         _ptr(scratch, np.int32, ctypes.c_int))
    return [np.stack([src[edge_offsets[c]:edge_offsets[c] + counts[c]],
                      dst[edge_offsets[c]:edge_offsets[c] + counts[c]]])
            for c in range(n_c)]
