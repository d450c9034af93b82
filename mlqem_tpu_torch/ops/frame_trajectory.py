"""Pauli-frame trajectory engine for rotation+Clifford circuits, in torch.

Counterpart of ``mlqem_tpu/ops/frame_trajectory.py``, on the gate set
{id, x, y, z, h, s, sdg, t, tdg, sx, sxdg, rx, ry, rz, p, rzz, cx, cy, cz,
swap}. Sampled Pauli noise is never applied to the state. Each trajectory
keeps a Pauli *frame* F (two int32 bit masks, X and Z) with
``state_phys = F · state_frame``:

* a noise Pauli left-multiplies the frame — two XORs;
* a 2q Clifford conjugates the frame (a 16-entry table over the two
  qubits' bits) and applies its *shared* permutation to the state;
* a rotation R_A(θ) passes through F unchanged, with θ sign-flipped when
  F anticommutes with the axis at that qubit;
* measurement: physical probabilities are the frame-X-mask XOR-permuted
  trajectory probabilities (frame phases are global and drop out).

Two engines: :func:`run_frame_trajectories_probs` evolves full
[B, T, 2^n] states in plain torch; :func:`run_frame_trajectories_z` walks
the frames with integer ops only (:func:`frame_theta_eff`), hands the
sign-folded angles to kernel K2
(:func:`~.kernels.frame_evolve.evolve_frame_marginals`), which returns
per-qubit marginals, and corrects those for the frame's X mask and the
readout confusion (:func:`frame_marginals_to_z`). Both batch over B
circuits and T trajectories at once.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..circuits.circuit import CircuitTensor
from ..circuits.gates import GATE_IDS
from .kernels import frame_evolve as fe
from .pauli_prop import _code_mat, _find_code_sign
from .unitaries import COMPLEX_DTYPE

# Pauli-axis rotations: gate → (axis, fixed angle or None=parameter).
# Phase/global-phase differences (s = e^{iπ/4} rz(π/2), t, sx, p, …) never
# reach probabilities, so every member reduces to rx/ry/rz semantics.
_ROTATIONS = {
    GATE_IDS["rx"]: ("x", None), GATE_IDS["ry"]: ("y", None),
    GATE_IDS["rz"]: ("z", None), GATE_IDS["p"]: ("z", None),
    GATE_IDS["x"]: ("x", np.pi), GATE_IDS["y"]: ("y", np.pi),
    GATE_IDS["z"]: ("z", np.pi),
    GATE_IDS["s"]: ("z", np.pi / 2), GATE_IDS["sdg"]: ("z", -np.pi / 2),
    GATE_IDS["t"]: ("z", np.pi / 4), GATE_IDS["tdg"]: ("z", -np.pi / 4),
    GATE_IDS["sx"]: ("x", np.pi / 2), GATE_IDS["sxdg"]: ("x", -np.pi / 2),
}
_ID_NOP = (GATE_IDS["nop"], GATE_IDS["id"])
_H = GATE_IDS["h"]
_CX, _CY, _CZ, _SWAP = (GATE_IDS["cx"], GATE_IDS["cy"], GATE_IDS["cz"],
                        GATE_IDS["swap"])
_RZZ = GATE_IDS["rzz"]
_CLIFF2 = (_CX, _CY, _CZ, _SWAP)
_SUPPORTED = (set(_ROTATIONS) | set(_ID_NOP) | {_H, _RZZ} | set(_CLIFF2))

# per-2q-Pauli-code (4·ca+cb, code 0=I,1=X,2=Y,3=Z) frame bit contributions
_CODE_X = np.array([c in (1, 2) for c in range(4)], np.int32)
_CODE_Z = np.array([c in (2, 3) for c in range(4)], np.int32)
XBIT_A = np.repeat(_CODE_X, 4).astype(np.int32)        # [16] x-bit of ca
ZBIT_A = np.repeat(_CODE_Z, 4).astype(np.int32)
XBIT_B = np.tile(_CODE_X, 4).astype(np.int32)          # [16] x-bit of cb
ZBIT_B = np.tile(_CODE_Z, 4).astype(np.int32)


def _conj2_table(U: np.ndarray) -> np.ndarray:
    """new_code[16]: how conjugation by the 2q Clifford U permutes the 16
    local Pauli codes (signs drop — they are global phases on the state)."""
    codes = np.zeros(16, np.int32)
    for c in range(16):
        nc, s = _find_code_sign(U @ _code_mat(c) @ U.conj().T)
        if s not in (1, -1):
            raise ValueError(f"U maps Pauli code {c} to a non-Hermitian "
                             f"phase {s}")
        codes[c] = nc
    return codes


# dense 4x4s match ops/unitaries.py (a = MSB convention)
_Y2 = np.array([[0, -1j], [1j, 0]])
_CLIFF2_CODES = {
    _CX: _conj2_table(np.eye(4)[[0, 1, 3, 2]].astype(complex)),
    _CY: _conj2_table(np.block([[np.eye(2), np.zeros((2, 2))],
                                [np.zeros((2, 2)), _Y2]])),
    _CZ: _conj2_table(np.diag([1.0, 1, 1, -1]).astype(complex)),
    _SWAP: _conj2_table(np.eye(4)[[0, 2, 1, 3]].astype(complex)),
}

# local code of a qubit from its frame bits, indexed 2·x + z: I, Z, X, Y
_LOCAL_CODE = np.array([0, 3, 1, 2], np.int32)


def _packed_conj_table(codes: np.ndarray) -> np.ndarray:
    """The Clifford's code table re-indexed by frame bits: entry
    8·xa + 4·za + 2·xb + zb holds the new bits packed the same way."""
    out = np.zeros(16, np.int32)
    for bits in range(16):
        xa, za, xb, zb = (bits >> 3) & 1, (bits >> 2) & 1, (bits >> 1) & 1, \
            bits & 1
        nc = codes[4 * _LOCAL_CODE[2 * xa + za] + _LOCAL_CODE[2 * xb + zb]]
        out[bits] = (8 * XBIT_A[nc] + 4 * ZBIT_A[nc] + 2 * XBIT_B[nc]
                     + ZBIT_B[nc])
    return out


_PACKED_CONJ = {g: _packed_conj_table(c) for g, c in _CLIFF2_CODES.items()}


def frame_supported(ct: CircuitTensor, num_qubits: Optional[int] = None
                    ) -> bool:
    """True when every op is in the frame gate set and the width fits the
    int32 frame masks."""
    n = num_qubits if num_qubits is not None else ct.num_qubits
    if n > 30:
        return False
    gids = np.asarray(ct.gate_ids).reshape(-1)
    return bool(np.all(np.isin(gids, list(_SUPPORTED))))


def _structure(ct_struct: CircuitTensor) -> Tuple[np.ndarray, np.ndarray]:
    """The shared op list as host (gate_ids [L], qubits [L, 2])."""
    return (np.asarray(ct_struct.gate_ids, np.int32).reshape(-1),
            np.asarray(ct_struct.qubits, np.int32).reshape(-1, 2))


# ---------------------------------------------------------------------------
# frame algebra on int32 masks (shared by both engines)
# ---------------------------------------------------------------------------
class _Frames:
    """X/Z frame masks of every trajectory, int32 [...], with the noise
    masks of every op precomputed from ``choices`` [..., L]."""

    def __init__(self, qubits: np.ndarray, choices: torch.Tensor):
        device = choices.device
        L = qubits.shape[0]
        a = qubits[:, 0:1].astype(np.int64)
        b = qubits[:, 1:2].astype(np.int64)
        # [L, 16]: the frame bits the 2q Pauli code adds at op l's qubits
        tab_x = (XBIT_A[None] << a) ^ (XBIT_B[None] << b)
        tab_z = (ZBIT_A[None] << a) ^ (ZBIT_B[None] << b)
        flat = (choices.long()
                + 16 * torch.arange(L, device=device)).movedim(-1, 0)

        def noise(tab):
            t = torch.as_tensor(tab.reshape(-1).astype(np.int32),
                                device=device)
            return t[flat].contiguous()                   # [L, ...]

        self.noise_x, self.noise_z = noise(tab_x), noise(tab_z)
        lead = choices.shape[:-1]
        self.x = torch.zeros(lead, dtype=torch.int32, device=device)
        self.z = torch.zeros_like(self.x)
        self._tables = {g: torch.as_tensor(t, device=device)
                        for g, t in _PACKED_CONJ.items()}

    def conjugate(self, g: int, a: int, b: int):
        """Conjugate the frames through 2q Clifford g on qubits (a, b)."""
        x, z = self.x, self.z
        bits = ((((x >> a) & 1) << 3) | (((z >> a) & 1) << 2)
                | (((x >> b) & 1) << 1) | ((z >> b) & 1))
        new = self._tables[g][bits.long()]
        clear = ~((1 << a) | (1 << b)) & 0x7fffffff
        self.x = (x & clear) | (((new >> 3) & 1) << a) \
            | (((new >> 1) & 1) << b)
        self.z = (z & clear) | (((new >> 2) & 1) << a) | ((new & 1) << b)

    def hadamard(self, a: int):
        """X↔Z bit swap at qubit a."""
        d = ((self.x ^ self.z) >> a) & 1
        self.x = self.x ^ (d << a)
        self.z = self.z ^ (d << a)

    def anticommutes(self, axis: str, a: int, b: int) -> torch.Tensor:
        """int32 0/1: does the frame anticommute with the rotation axis?"""
        x, z = self.x, self.z
        if axis == "zz":
            return ((x >> a) ^ (x >> b)) & 1
        if axis == "x":
            return (z >> a) & 1
        if axis == "z":
            return (x >> a) & 1
        return ((x ^ z) >> a) & 1

    def add_noise(self, l: int):
        """Left-multiply op l's sampled noise Pauli into the frames."""
        self.x = self.x ^ self.noise_x[l]
        self.z = self.z ^ self.noise_z[l]


# ---------------------------------------------------------------------------
# plain engine: full states
# ---------------------------------------------------------------------------
def run_frame_trajectories_probs(ct_struct: CircuitTensor,
                                 params: torch.Tensor,
                                 choices: torch.Tensor,
                                 num_qubits: int) -> torch.Tensor:
    """Physical outcome distributions: f32 [B, T, dim].

    Same contract as ``run_trajectories_presampled`` + |amplitude|², for
    circuits passing :func:`frame_supported`. params [B, L, 3] (a tensor;
    its device is the engine's), choices int [B, T, L] (16-code 2q Paulis
    at each op's qubit pair); gate_ids/qubits [L] shared, from ct_struct.
    """
    gate_ids, qubits = _structure(ct_struct)
    params = torch.as_tensor(params, dtype=torch.float32)
    device = params.device
    choices = torch.as_tensor(choices, device=device)
    n = max(num_qubits, 2)
    dim = 2 ** n
    B, T, L = choices.shape
    j = torch.arange(dim, dtype=torch.int64, device=device)
    bit = [((j >> q) & 1).to(torch.float32) for q in range(n)]
    sign = [1.0 - 2.0 * bq for bq in bit]

    def flip(st, q):
        return st.index_select(-1, j ^ (1 << q))

    st = torch.zeros((B, T, dim), dtype=COMPLEX_DTYPE, device=device)
    st[..., 0] = 1.0
    frames = _Frames(qubits, choices)
    for l in range(L):
        g = int(gate_ids[l])
        a, b = int(qubits[l, 0]), int(qubits[l, 1])
        if g in _ID_NOP:
            # the GATE is trivial but its noise channel is not ('id' under
            # a device model carries idle T1/T2 error): only the state
            # update is skipped, the sampled Pauli still enters the frame
            pass
        elif g in _CLIFF2:
            if g == _CX:
                st = st * (1.0 - bit[a]) + flip(st, b) * bit[a]
            elif g == _CY:
                yb = 1j * (-sign[b])                    # i(2·bit_b−1)
                st = st * (1.0 - bit[a]) + yb * flip(st, b) * bit[a]
            elif g == _CZ:
                st = st * (1.0 - 2.0 * bit[a] * bit[b])
            else:  # swap: exchange bits a and b where they differ
                differ = bit[a] + bit[b] - 2.0 * bit[a] * bit[b]
                st = st * (1.0 - differ) + flip(flip(st, a), b) * differ
            frames.conjugate(g, a, b)
        elif g == _H:
            st = (sign[a] * st + flip(st, a)) * np.float32(1 / np.sqrt(2))
            frames.hadamard(a)
        else:
            axis, fixed = ("zz", None) if g == _RZZ else _ROTATIONS[g]
            theta = (params[:, l, 0] if fixed is None else torch.full(
                (B,), float(np.float32(fixed)), device=device))
            anti = frames.anticommutes(axis, a, b)
            s_t = (1.0 - 2.0 * anti.to(torch.float32))[..., None]  # [B,T,1]
            c = torch.cos(theta / 2.0)[:, None, None]
            sn = torch.sin(theta / 2.0)[:, None, None]
            w = s_t * sn
            if axis == "zz":
                st = st * (c - 1j * w * (sign[a] * sign[b]))
            elif axis == "z":
                st = st * (c - 1j * w * sign[a])
            elif axis == "x":
                st = c * st - 1j * w * flip(st, a)
            else:  # y: (Yψ)_j = i(2b_j−1)·ψ_flip → c·st − w·(1−2b)·flip
                st = c * st - w * sign[a] * flip(st, a)
        frames.add_noise(l)
    probs = st.real * st.real + st.imag * st.imag
    # physical probs: XOR-permute by the frame X mask
    return torch.gather(probs, -1, j ^ frames.x[..., None].long())


# ---------------------------------------------------------------------------
# fused marginal path (kernel K2 on CUDA)
# ---------------------------------------------------------------------------
def _build_plan(gate_ids: np.ndarray, qubits: np.ndarray):
    """Kernel plan + per-rotation angle metadata.

    Returns (plan, rot_meta): plan is a tuple of (kind, a, b, theta_slot)
    for :func:`~.kernels.frame_evolve.evolve_frame_marginals`; rot_meta is
    a list of (op_index, axis, fixed_angle_or_None) — one entry per theta
    slot, in op order (the sign-folded angle stream's columns).
    """
    plan = []
    rot_meta = []
    kind_1q = {"x": fe.ROT_X, "y": fe.ROT_Y, "z": fe.ROT_Z}
    cliff = {_CX: fe.GATE_CX, _CY: fe.GATE_CY, _CZ: fe.GATE_CZ,
             _SWAP: fe.GATE_SWAP}
    for l, g in enumerate(gate_ids):
        g = int(g)
        a, b = int(qubits[l, 0]), int(qubits[l, 1])
        if g in _ID_NOP:
            continue
        if g in _CLIFF2:
            plan.append((cliff[g], a, b, -1))
        elif g == _H:
            plan.append((fe.GATE_H, a, b, -1))
        elif g == _RZZ:
            plan.append((fe.ROT_ZZ, a, b, len(rot_meta)))
            rot_meta.append((l, "zz", None))
        else:
            axis, fixed = _ROTATIONS[g]
            plan.append((kind_1q[axis], a, b, len(rot_meta)))
            rot_meta.append((l, axis, fixed))
    return tuple(plan), rot_meta


def _frame_walk(gate_ids: np.ndarray, qubits: np.ndarray, rot_meta,
                choices: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integer-only frame evolution: rotation signs + final X mask.

    choices int [..., L] → (signs f32 [..., n_rot] ∈ {±1} in theta-slot
    order, fx int32 [...]). The same frame updates as
    :func:`run_frame_trajectories_probs` (gate conjugation, then the
    sampled noise Pauli) without touching a state.
    """
    frames = _Frames(qubits, choices)
    lead = choices.shape[:-1]
    axis_of = {l: ax for (l, ax, _) in rot_meta}
    # [n_rot, ...] so each slot is written contiguously
    signs = torch.empty((len(rot_meta),) + tuple(lead), dtype=torch.float32,
                        device=choices.device)
    r = 0
    for l in range(gate_ids.shape[0]):
        g = int(gate_ids[l])
        a, b = int(qubits[l, 0]), int(qubits[l, 1])
        if g in _ID_NOP:
            pass
        elif g in _CLIFF2:
            frames.conjugate(g, a, b)
        elif g == _H:
            frames.hadamard(a)
        else:
            anti = frames.anticommutes(axis_of[l], a, b)
            signs[r] = 1.0 - 2.0 * anti.to(torch.float32)
            r += 1
        frames.add_noise(l)
    return signs.movedim(0, -1), frames.x


@functools.lru_cache(maxsize=32)
def _cached_plan(gids: Tuple[int, ...], qubs: Tuple[Tuple[int, int], ...]):
    return _build_plan(np.asarray(gids, np.int32).reshape(-1),
                       np.asarray(qubs, np.int32).reshape(-1, 2))


def frame_plan(ct_struct: CircuitTensor):
    """(plan, rot_meta) of a template's shared op list (cached)."""
    gate_ids, qubits = _structure(ct_struct)
    return _cached_plan(tuple(int(g) for g in gate_ids),
                        tuple((int(a), int(b)) for a, b in qubits))


def frame_theta_eff(ct_struct: CircuitTensor, params: torch.Tensor,
                    choices: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, tuple]:
    """Walk the frames and fold their signs into the circuits' angles.

    params [B, L, 3], choices int [B, T, L] → (theta_eff f32 [B·T, R]
    contiguous, rows in (circuit, trajectory) order; fx int32 [B, T]; the
    kernel plan).
    """
    gate_ids, qubits = _structure(ct_struct)
    plan, rot_meta = frame_plan(ct_struct)
    params = torch.as_tensor(params, dtype=torch.float32)
    choices = torch.as_tensor(choices, device=params.device)
    B, T, _ = choices.shape
    R = len(rot_meta)
    signs, fx = _frame_walk(gate_ids, qubits, rot_meta, choices)  # [B,T,R]
    # per-circuit base angles in theta-slot order
    cols: List[torch.Tensor] = [
        params[:, l, 0] if fixed is None else torch.full(
            (B,), float(np.float32(fixed)), device=params.device)
        for (l, _, fixed) in rot_meta]
    theta_circ = (torch.stack(cols, dim=-1) if R else
                  torch.zeros((B, 0), device=params.device))    # [B, R]
    theta_eff = (signs * theta_circ[:, None, :]).reshape(B * T, R)
    return theta_eff.contiguous(), fx, plan


def frame_marginals_to_z(p1: torch.Tensor, fx: torch.Tensor,
                         confusion: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Frame-basis P(1) [..., nq] → physical ⟨Z_q⟩ [..., nq].

    The frame's X mask flips each measured bit it covers (p1 ↔ p0); then
    the per-qubit readout confusion [nq, 2, 2] (M[meas, true]) applies.
    Both act on each qubit's marginal alone, so this is exact.
    """
    nq = p1.shape[-1]
    qs = torch.arange(nq, dtype=torch.int32, device=p1.device)
    fxbit = ((fx[..., None] >> qs) & 1).to(torch.float32)
    p1 = p1 + fxbit * (1.0 - 2.0 * p1)
    if confusion is not None:
        m = confusion.to(torch.float32)
        p1 = m[:, 1, 0] * (1.0 - p1) + m[:, 1, 1] * p1
    return 1.0 - 2.0 * p1


def run_frame_trajectories_z(ct_struct: CircuitTensor,
                             params: torch.Tensor,
                             choices: torch.Tensor,
                             num_qubits: int,
                             confusion: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Per-qubit physical ⟨Z_q⟩ (readout applied): [B, T, nq].

    Equivalent to ``z_expectations(apply_readout_confusion(
    run_frame_trajectories_probs(…)))``, but the states never leave kernel
    K2 on a CUDA device (its plain version on the CPU): only the
    sign-folded angles go in and [B·T, nq] marginals come out.
    """
    B, T, _ = choices.shape
    theta_eff, fx, plan = frame_theta_eff(ct_struct, params, choices)
    p1 = fe.evolve_frame_marginals(theta_eff, plan, num_qubits)
    if confusion is not None:
        confusion = torch.as_tensor(confusion, dtype=torch.float32,
                                    device=p1.device)
    return frame_marginals_to_z(p1.reshape(B, T, num_qubits), fx,
                                confusion)
