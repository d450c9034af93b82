"""Per-op 4x4 unitaries and bit-index helpers, in torch.

Counterpart of ``mlqem_tpu/ops/unitaries.py``. Given tensorized ops
``(gate_ids[..., L], params[..., L, 3])`` :func:`op_unitaries` builds every
op's 4x4 unitary at once as complex64 ``[..., L, 4, 4]``: each gate kind's
matrix is evaluated for all ops and put in place under that kind's mask;
every other op (structural, NOP padding) gets the identity.

1q gates are embedded as ``U ⊗ I`` on (first operand = MSB, partner = LSB),
matching the convention in :mod:`mlqem_tpu_torch.circuits.gates`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..circuits.gates import GATE_IDS

COMPLEX_DTYPE = torch.complex64

_CONST_1Q = {
    "x": np.array([[0, 1], [1, 0]]),
    "y": np.array([[0, -1j], [1j, 0]]),
    "z": np.diag([1, -1]),
    "h": np.array([[1, 1], [1, -1]]) / np.sqrt(2),
    "s": np.diag([1, 1j]),
    "sdg": np.diag([1, -1j]),
    "t": np.diag([1, np.exp(1j * np.pi / 4)]),
    "tdg": np.diag([1, np.exp(-1j * np.pi / 4)]),
    "sx": 0.5 * np.array([[1 + 1j, 1 - 1j], [1 - 1j, 1 + 1j]]),
    "sxdg": 0.5 * np.array([[1 - 1j, 1 + 1j], [1 + 1j, 1 - 1j]]),
}


def _controlled_np(u):
    return np.block([[np.eye(2), np.zeros((2, 2))], [np.zeros((2, 2)), u]])


_CONST_2Q = {
    "cx": _controlled_np(_CONST_1Q["x"]),
    "cy": _controlled_np(_CONST_1Q["y"]),
    "cz": np.diag([1, 1, 1, -1]),
    "ch": _controlled_np(_CONST_1Q["h"]),
    "swap": np.array([[1, 0, 0, 0], [0, 0, 1, 0],
                      [0, 1, 0, 0], [0, 0, 0, 1]]),
    # ECR(a,b) in a=MSB convention: (X_a⊗I_b - Y_a⊗X_b)/sqrt(2); must
    # match circuits/gates.py:gate_unitary("ecr").
    "ecr": (np.kron(_CONST_1Q["x"], np.eye(2))
            - np.kron(_CONST_1Q["y"], _CONST_1Q["x"])) / np.sqrt(2),
}


def _kron_u_i(u: torch.Tensor) -> torch.Tensor:
    """kron(U, I2) for U[..., 2, 2] → [..., 4, 4]."""
    eye = torch.eye(2, dtype=u.dtype, device=u.device)
    out = u[..., :, None, :, None] * eye[:, None, :]
    return out.reshape(u.shape[:-2] + (4, 4))


def _controlled(u: torch.Tensor) -> torch.Tensor:
    """diag-block [[I, 0], [0, U]] for U[..., 2, 2] → [..., 4, 4]."""
    out = torch.zeros(u.shape[:-2] + (4, 4), dtype=u.dtype, device=u.device)
    out[..., 0, 0] = 1.0
    out[..., 1, 1] = 1.0
    out[..., 2:, 2:] = u
    return out


def _expi(x: torch.Tensor) -> torch.Tensor:
    """exp(i·x) for real f32 x, as complex64."""
    return torch.polar(torch.ones_like(x), x)


def _u3(theta, phi, lam) -> torch.Tensor:
    """u3 matrices for angle tensors [...] → complex64 [..., 2, 2]."""
    c = torch.cos(theta / 2).to(COMPLEX_DTYPE)
    s = torch.sin(theta / 2).to(COMPLEX_DTYPE)
    el, ep = _expi(lam), _expi(phi)
    row0 = torch.stack([c, -el * s], dim=-1)
    row1 = torch.stack([ep * s, ep * el * c], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def _diag(*entries) -> torch.Tensor:
    """diag(entries) for complex tensors [...] → [..., k, k]."""
    return torch.diag_embed(torch.stack(entries, dim=-1))


def op_unitaries(gate_ids, params: torch.Tensor) -> torch.Tensor:
    """All per-op 4x4 unitaries: int[..., L], f32[..., L, 3] → complex64
    [..., L, 4, 4] on ``params``' device (shapes broadcast).

    Structural ops and NOP padding produce the identity.
    """
    params = torch.as_tensor(params, dtype=torch.float32)
    device = params.device
    if torch.is_tensor(gate_ids):
        present = set(GATE_IDS.values())
        gate_ids = gate_ids.to(device)
    else:   # host ids: build only the kinds that occur
        present = set(np.unique(np.asarray(gate_ids)).tolist())
        gate_ids = torch.tensor(np.asarray(gate_ids), device=device)
    shape = torch.broadcast_shapes(gate_ids.shape, params.shape[:-1])
    t, f, l = (params[..., k].expand(shape) for k in range(3))
    zeros = torch.zeros_like(t)
    half = t / 2

    def const(m):
        return torch.as_tensor(np.asarray(m, np.complex64), device=device)

    def rz():
        return _diag(_expi(-half), _expi(half))

    def pgate():
        return _diag(torch.ones_like(t).to(COMPLEX_DTYPE), _expi(t))

    def rxx_ryy(sign_yy):
        cc = torch.cos(half).to(COMPLEX_DTYPE)
        ss = torch.sin(half).to(COMPLEX_DTYPE)
        out = _diag(cc, cc, cc, cc)
        out[..., 0, 3] = out[..., 3, 0] = sign_yy * 1j * ss
        out[..., 1, 2] = out[..., 2, 1] = -1j * ss
        return out

    # each kind's [..., 4, 4] builder; only the kinds that occur are built
    builders = {name: (lambda m=m: _kron_u_i(const(m)))
                for name, m in _CONST_1Q.items()}
    builders.update({
        "rx": lambda: _kron_u_i(_u3(t, zeros - np.pi / 2, zeros + np.pi / 2)),
        "ry": lambda: _kron_u_i(_u3(t, zeros, zeros)),
        "rz": lambda: _kron_u_i(rz()),
        "p": lambda: _kron_u_i(pgate()),
        "u2": lambda: _kron_u_i(_u3(zeros + np.pi / 2, t, f)),
        "u3": lambda: _kron_u_i(_u3(t, f, l)),
        "crz": lambda: _controlled(rz()),
        "cp": lambda: _controlled(pgate()),
        "cu3": lambda: _controlled(_u3(t, f, l)),
        "rzz": lambda: _diag(_expi(-half), _expi(half), _expi(half),
                             _expi(-half)),
        "rxx": lambda: rxx_ryy(-1),
        "ryy": lambda: rxx_ryy(1),
    })
    builders.update({name: (lambda m=m: const(m))
                     for name, m in _CONST_2Q.items()})

    mats = torch.eye(4, dtype=COMPLEX_DTYPE, device=device).expand(
        shape + (4, 4))
    for name, build in builders.items():
        if GATE_IDS[name] in present:
            mask = (gate_ids == GATE_IDS[name])[..., None, None]
            mats = torch.where(mask, build(), mats)
    return mats


def insert_bit(v: torch.Tensor, pos) -> torch.Tensor:
    """Insert a 0-bit at position ``pos``: (v >> pos << (pos+1)) | low bits."""
    low_mask = (1 << pos) - 1
    return ((v >> pos) << (pos + 1)) | (v & low_mask)


def pair_indices(a, b, n: int) -> torch.Tensor:
    """Gather indices for a 2q op at qubits (a, b), a != b.

    ``a`` and ``b`` are ints or int tensors of one shape [...] (one op per
    row). Returns int64 [..., 4, 2**(n-2)]: row m holds the global indices
    whose local 2-bit value is m = 2*v_a + v_b, enumerated over the other
    n-2 qubits.
    """
    a = torch.as_tensor(a, dtype=torch.int64)
    b = torch.as_tensor(b, dtype=torch.int64, device=a.device)
    base = torch.arange(2 ** (n - 2), dtype=torch.int64, device=a.device)
    a_, b_ = a[..., None], b[..., None]
    t = insert_bit(base, torch.minimum(a_, b_))
    t = insert_bit(t, torch.maximum(a_, b_))
    bit_a, bit_b = 1 << a_, 1 << b_
    return torch.stack([t, t | bit_b, t | bit_a, t | bit_a | bit_b], dim=-2)


def popcount(v: torch.Tensor) -> torch.Tensor:
    """Population count of the low 32 bits of an int tensor (SWAR)."""
    v = v.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)
