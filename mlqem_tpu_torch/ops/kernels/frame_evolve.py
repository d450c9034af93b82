"""Fused generic Pauli-frame evolution: the CUDA kernel's wrapper and its
plain PyTorch version.

:func:`evolve_frame_marginals` takes the same inputs as the JAX package's
``ops/pallas/frame_evolve.py::evolve_frame_marginals``: per-row
sign-folded angles ``theta_eff`` [rows, n_rot] and a plan, a tuple of
``(kind, a, b, slot)`` ops. Every row starts at |0…0⟩, runs the plan and
yields its per-qubit P(1) [rows, nq]. On CUDA tensors it launches the
hand-written kernel of ``csrc/frame_evolve.cu`` (built with ``nvcc`` at
first use) on the current stream, or raises; on CPU tensors it runs
:func:`evolve_frame_marginals_reference`. The kernel runs the plan as
:func:`fuse_plan` merges it, which gives the same marginals.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from ...utils.build import build_library

# op kinds of a plan (the JAX package's values)
ROT_Z, ROT_X, ROT_Y, ROT_ZZ = 0, 1, 2, 3
GATE_H, GATE_CX, GATE_CY, GATE_CZ, GATE_SWAP = 4, 5, 6, 7, 8
ROTATION_KINDS = (ROT_Z, ROT_X, ROT_Y, ROT_ZZ)
TWO_QUBIT_KINDS = (ROT_ZZ, GATE_CX, GATE_CY, GATE_CZ, GATE_SWAP)

MAX_NQ = 30                       # the frame engine's widest row
MAX_SMEM_NQ = 13                  # widths the kernel holds on chip
MAX_WARP_NQ = 10                  # widths the kernel holds in registers
_SCRATCH_BYTES = 1 << 30          # the row slots above MAX_SMEM_NQ, at most
_MAX_SMEM_BYTES = 232448 - 1024   # per-block shared memory on sm_90, less
#                                   the kernel's static reduction scratch
_INV_SQRT2 = float(np.float32(1.0 / np.sqrt(2.0)))

Plan = Tuple[Tuple[int, int, int, int], ...]


def check_plan(plan: Sequence, nq: int, n_rot: int) -> Plan:
    """The plan as a tuple of int 4-tuples; raises on an unknown kind, a
    qubit outside [0, nq), a 2q op on one qubit or a rotation slot outside
    [0, n_rot). The second qubit of a 1q op is padding and is not read."""
    out = []
    for op in plan:
        kind, a, b, slot = (int(x) for x in op)
        if not GATE_SWAP >= kind >= ROT_Z:
            raise ValueError(f"unknown plan kind {kind} in {op}")
        if not 0 <= a < nq or (kind in TWO_QUBIT_KINDS
                               and not (0 <= b < nq and a != b)):
            raise ValueError(f"plan op {op} has qubits outside [0, {nq}) "
                             "or a 2q op on one qubit")
        if kind in ROTATION_KINDS and not 0 <= slot < n_rot:
            raise ValueError(f"plan op {op} reads angle slot {slot} of "
                             f"{n_rot}")
        out.append((kind, a, b, slot))
    return tuple(out)


def every_kind_plan(rng: np.random.Generator, nq: int, n_ops: int
                    ) -> Tuple[Plan, int]:
    """A random plan of ``n_ops`` ops that cycles through every op kind
    (the 1q kinds only at nq = 1), for holding the kernel to its plain
    version. Returns (plan, number of angle slots)."""
    kinds = (list(range(GATE_SWAP + 1)) if nq >= 2 else
             [ROT_Z, ROT_X, ROT_Y, GATE_H])
    plan, slot = [], 0
    for i in range(n_ops):
        kind = kinds[i % len(kinds)]
        a = int(rng.integers(nq))
        b = (a + 1 + int(rng.integers(nq - 1))) % nq if nq >= 2 else 1
        plan.append((kind, a, b, slot if kind in ROTATION_KINDS else -1))
        slot += kind in ROTATION_KINDS
    return tuple(plan), slot


def every_path_plan(rng: np.random.Generator, nq: int) -> Tuple[Plan, int]:
    """A plan that moves every qubit with every kind: rx, ry and h on each
    qubit, cx and cy onto each qubit (random controls) and swap of each
    qubit with a random other, with rz, rzz and cz between them and an rx
    layer first so that no op meets a trivial state. At nq ≥ 6 the kernel
    runs each of its code paths (five register positions and the lane
    path) for each kind. Returns (plan, number of angle slots)."""
    plan, slot = [], 0

    def add(kind, a, b):
        nonlocal slot
        rot = kind in ROTATION_KINDS
        plan.append((kind, a, b, slot if rot else -1))
        slot += rot

    def other(q):
        return (q + 1 + int(rng.integers(nq - 1))) % nq

    for q in range(nq):
        add(ROT_X, q, 0)
    kinds = ((ROT_X, ROT_Y, GATE_H) if nq == 1 else
             (ROT_X, ROT_Y, GATE_H, GATE_CX, GATE_CY, GATE_SWAP))
    for kind in kinds:
        for t in range(nq):
            if kind in (GATE_CX, GATE_CY):
                add(kind, other(t), t)
            else:
                add(kind, t, other(t) if nq > 1 else 0)
            q = int(rng.integers(nq))
            if nq == 1:
                add(ROT_Z, q, 0)
            else:
                add((ROT_Z, ROT_ZZ, GATE_CZ)[t % 3], q, other(q))
    return tuple(plan), slot


def _qubits(op) -> Tuple[int, ...]:
    return op[1:3] if op[0] in TWO_QUBIT_KINDS else op[1:2]


@functools.lru_cache(maxsize=64)
def fuse_plan(plan: Plan) -> Plan:
    """The plan with each rz(b) that sits between two cx(a, b) merged with
    them into rzz(a, b) on the rz's angle slot, where no op between the
    three touches a or b.

    Exact, bit for bit in the marginals: a CX is a permutation of the
    amplitudes, so it commutes exactly with any op on other qubits (each
    amplitude gets the same arithmetic on the same values, elsewhere), and
    CX·RZ_b(θ)·CX = RZZ_ab(θ) applies the same cos and sin with the sign
    sgn(a)·sgn(b) that the conjugated rz sees. The bench template's 40 rx
    + 36 rz + 72 cx become 40 rx + 36 rzz.
    """
    ops = list(plan)
    i = 0
    while i < len(ops):
        op = ops[i]
        if op[0] == ROT_Z:
            b = op[1]
            before = next((k for k in range(i - 1, -1, -1)
                           if b in _qubits(ops[k])), None)
            if before is not None and ops[before][0] == GATE_CX \
                    and ops[before][2] == b:
                cx = ops[before][:3]
                pair = set(cx[1:])
                if all(not pair & set(_qubits(ops[k]))
                       for k in range(before + 1, i)):
                    after = next((k for k in range(i + 1, len(ops))
                                  if pair & set(_qubits(ops[k]))), None)
                    if after is not None and ops[after][:3] == cx:
                        ops[i] = (ROT_ZZ, cx[1], b, op[3])
                        del ops[after], ops[before]
                        i -= 1
        i += 1
    return tuple(ops)


def evolve_frame_marginals_reference(theta_eff: torch.Tensor, plan: Plan,
                                     nq: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same op loop on
    [rows, 2^nq] re/im planes, with each bit flip an ``index_select`` at
    ``j ^ (1 << q)`` and the formulas of the JAX kernel
    (``frame_evolve.py:84-125``)."""
    rows, dim = theta_eff.shape[0], 1 << nq
    device = theta_eff.device
    j = torch.arange(dim, dtype=torch.int64, device=device)
    bit = [((j >> q) & 1).to(torch.float32) for q in range(nq)]
    sgn = [1.0 - 2.0 * b for b in bit]
    flip_idx = [j ^ (1 << q) for q in range(nq)]

    def flip(v, q):
        return v.index_select(-1, flip_idx[q])

    re = torch.zeros((rows, dim), dtype=torch.float32, device=device)
    re[:, 0] = 1.0
    im = torch.zeros_like(re)
    for kind, a, b, slot in plan:
        if kind in ROTATION_KINDS:
            th = 0.5 * theta_eff[:, slot:slot + 1]
            c, s = torch.cos(th), torch.sin(th)
            if kind in (ROT_Z, ROT_ZZ):
                sv = s * (sgn[a] if kind == ROT_Z else sgn[a] * sgn[b])
                re, im = re * c + im * sv, im * c - re * sv
            elif kind == ROT_X:
                fr, fi = flip(re, a), flip(im, a)
                re, im = c * re + s * fi, c * im - s * fr
            else:                                        # ROT_Y
                sv = s * sgn[a]
                re, im = c * re - sv * flip(re, a), c * im - sv * flip(im, a)
        elif kind == GATE_H:
            re = (sgn[a] * re + flip(re, a)) * _INV_SQRT2
            im = (sgn[a] * im + flip(im, a)) * _INV_SQRT2
        elif kind == GATE_CX:
            ctl = bit[a]
            re = re * (1.0 - ctl) + flip(re, b) * ctl
            im = im * (1.0 - ctl) + flip(im, b) * ctl
        elif kind == GATE_CY:
            ctl = bit[a]
            nre = sgn[b] * flip(im, b)
            nim = -sgn[b] * flip(re, b)
            re = re * (1.0 - ctl) + nre * ctl
            im = im * (1.0 - ctl) + nim * ctl
        elif kind == GATE_CZ:
            d = 1.0 - 2.0 * bit[a] * bit[b]
            re, im = re * d, im * d
        else:                                            # GATE_SWAP
            differ = bit[a] + bit[b] - 2.0 * bit[a] * bit[b]
            fre, fim = flip(flip(re, a), b), flip(flip(im, a), b)
            re = re * (1.0 - differ) + fre * differ
            im = im * (1.0 - differ) + fim * differ
    probs = re * re + im * im
    return torch.stack([(probs * bit[q]).sum(dim=-1) for q in range(nq)],
                       dim=-1)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load ``csrc/frame_evolve.cu``."""
    lib = build_library("frame_evolve")
    fn = lib.evolve_frame_marginals_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=64)
def _plan_tensor(plan: Plan, device: torch.device) -> torch.Tensor:
    """The plan as an int32 [n_ops, 4] tensor on ``device``."""
    return torch.as_tensor(np.asarray(plan, np.int32).reshape(-1, 4),
                           device=device)


def _smem_bytes(nq: int, n_ops: int, n_rot: int) -> int:
    """The least dynamic shared memory of one block: the plan (nq ≤ 10,
    where the angle table is left out if it does not fit), the plan and
    the cos/sin (nq 14-30, the row in global memory), or those and the
    re/im planes (nq 11-13)."""
    if nq <= MAX_WARP_NQ:
        return 16 * n_ops
    planes = 8 * (1 << nq) if nq <= MAX_SMEM_NQ else 0
    return 16 * n_ops + 8 * n_rot + planes


def scratch_slots(nq: int, rows: int, sms: int) -> int:
    """Row slots of the global-memory tier (nq > 13): one a block, at most
    four blocks of 512 threads an SM and ``_SCRATCH_BYTES`` of slots (at
    least one); 0 at nq ≤ 13, where no slot is read."""
    if nq <= MAX_SMEM_NQ:
        return 0
    return max(1, min(rows, 4 * sms, _SCRATCH_BYTES // (8 << nq)))


def evolve_frame_marginals(theta_eff: torch.Tensor, plan: Sequence,
                           nq: int) -> torch.Tensor:
    """Frame-basis per-qubit P(1): theta_eff [rows, n_rot] → [rows, nq].

    ``plan`` is the op list: (kind, a, b, theta_slot) per op. Rows whose
    trajectories share a circuit must already have the circuit's angles
    broadcast (sign-folded per trajectory). With no rotation (n_rot = 0)
    the angles are one zero column, as in the JAX package. CPU tensors go
    to :func:`evolve_frame_marginals_reference`; CUDA tensors to the
    kernel, which takes contiguous f32 angles and 1 ≤ nq ≤ 30 on an sm_90
    card (above 13 qubits each row lives in a slot of a scratch buffer in
    device memory, :func:`scratch_slots`).
    """
    rows = theta_eff.shape[0]
    device = theta_eff.device
    if theta_eff.dim() != 2:
        raise ValueError(f"theta_eff must be [rows, n_rot], got shape "
                         f"{tuple(theta_eff.shape)}")
    if theta_eff.shape[1] == 0:
        theta_eff = torch.zeros((rows, 1), dtype=theta_eff.dtype,
                                device=device)
    n_rot = theta_eff.shape[1]
    plan = check_plan(plan, nq, n_rot)
    if device.type == "cpu":
        return evolve_frame_marginals_reference(theta_eff, plan, nq)
    if device.type != "cuda":
        raise ValueError(f"evolve_frame_marginals runs on cpu or cuda, not "
                         f"{device}")
    if not 1 <= nq <= MAX_NQ:
        raise ValueError(f"the kernel takes 1 <= nq <= {MAX_NQ}, got {nq}")
    if theta_eff.dtype != torch.float32:
        raise TypeError(f"theta_eff must be float32, got {theta_eff.dtype}")
    if not theta_eff.is_contiguous():
        raise ValueError("theta_eff must be contiguous")
    if not rows < 2 ** 31:
        raise ValueError(f"the kernel takes fewer than 2^31 rows, got {rows}")
    plan = fuse_plan(plan)                     # what the kernel runs
    if _smem_bytes(nq, len(plan), n_rot) > _MAX_SMEM_BYTES:
        raise ValueError(f"a plan of {len(plan)} ops and {n_rot} angles at "
                         f"nq={nq} exceeds the kernel's shared memory")
    if torch.cuda.get_device_capability(device) != (9, 0):
        raise RuntimeError("the kernel is built for sm_90a; "
                           f"{torch.cuda.get_device_name(device)} is not")
    out = torch.empty((rows, nq), dtype=torch.float32, device=device)
    if rows == 0:
        return out
    plan_t = _plan_tensor(plan, device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    slots = scratch_slots(nq, rows, sms)
    scratch = torch.empty((slots, 2, 1 << nq) if slots else (0,),
                          dtype=torch.float32, device=device)
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.evolve_frame_marginals_launch(
            theta_eff.data_ptr(), plan_t.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), slots, rows, nq, len(plan), n_rot,
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"evolve_frame_marginals kernel launch failed: "
                           f"CUDA error {err}")
    evolve_frame_marginals.launches += 1
    return out


# kernel launches since the last reset (set it to 0 to reset)
evolve_frame_marginals.launches = 0
