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

Above 10 qubits the kernel runs the plan as :func:`frame_schedule` cuts it:
each qubit has a position (5 register bits, 5 lane bits, up to 4 warp bits
on chip, the rest off chip), every op that moves a bit finds it in a
register or lane position, and the schedule's relayouts (on chip) and
passes (over device memory, above 14 qubits) put it there.
:func:`emulate_schedule` runs a schedule in plain PyTorch, relayouts and
passes as permutations, so that the CPU tests hold it to the plain version.
"""
from __future__ import annotations

import bisect
import ctypes
import dataclasses
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

RELAYOUT = 9                      # a schedule's on-chip relayout
MOVING_KINDS = (ROT_X, ROT_Y, GATE_H, GATE_CX, GATE_CY)

MAX_NQ = 30                       # the frame engine's widest row
MAX_SMEM_NQ = 14                  # widths a row stays on chip (positions
#                                   a block of 512 threads holds)
MAX_WARP_NQ = 10                  # widths a row lies in one warp
NEAR = 10                         # positions a moving op runs on (regs, lanes)
LANES = range(5, 10)              # the lane positions
_HEADER = 4                       # int4 records of a pass's two maps
_RELAYOUT_BYTES = 4 * (33 << 9)  # the relayout buffer: a plane, padded
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


class _PlainOps:
    """The plain version's op loop on [rows, 2^nq] re/im planes, with each
    bit flip the amplitudes at ``j ^ (1 << q)`` (a flip of one axis of a
    [rows, ..., 2, 2^q] view) and the formulas of the JAX kernel
    (``frame_evolve.py:84-125``)."""

    def __init__(self, nq: int, device):
        j = torch.arange(1 << nq, dtype=torch.int64, device=device)
        self.bit = [((j >> q) & 1).to(torch.float32) for q in range(nq)]
        self.sgn = [1.0 - 2.0 * b for b in self.bit]

    @staticmethod
    def flip(v, q):
        rows, dim = v.shape
        return v.reshape(rows, dim >> (q + 1), 2, 1 << q).flip(2).reshape(
            rows, dim)

    def run(self, re, im, theta_eff, ops):
        bit, sgn, flip = self.bit, self.sgn, self.flip
        for kind, a, b, slot in ops:
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
                    re = c * re - sv * flip(re, a)
                    im = c * im - sv * flip(im, a)
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
        return re, im

    def marginals(self, re, im):
        """P(1) of each bit of the index: [rows, nq]."""
        probs = re * re + im * im
        return torch.stack([(probs * b).sum(dim=-1) for b in self.bit],
                           dim=-1)


def _zero_state(rows: int, nq: int, device):
    re = torch.zeros((rows, 1 << nq), dtype=torch.float32, device=device)
    re[:, 0] = 1.0
    return re, torch.zeros_like(re)


def evolve_frame_marginals_reference(theta_eff: torch.Tensor, plan: Plan,
                                     nq: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the plan's op loop on
    [rows, 2^nq] re/im planes (:class:`_PlainOps`), then P(1)."""
    plain = _PlainOps(nq, theta_eff.device)
    re, im = _zero_state(theta_eff.shape[0], nq, theta_eff.device)
    re, im = plain.run(re, im, theta_eff, plan)
    return plain.marginals(re, im)


# -- the schedule of the on-chip and device-memory tiers (nq 11-30) ---------

def _moved(op) -> int:
    """The qubit an op moves (rx, ry, h: a; cx, cy: the target b), or -1."""
    if op[0] not in MOVING_KINDS:
        return -1
    return op[2] if op[0] in (GATE_CX, GATE_CY) else op[1]


def pack_relayout(src: Sequence[int]) -> Tuple[int, int, int, int]:
    """A relayout instruction: the amplitude at new on-chip index P takes
    the one at the old index whose bit ``src[p]`` is bit p of P; ``src``
    for positions 0-13, 4 bits each (0-6 in the second field, 7-13 in the
    third)."""
    lo = sum(src[p] << (4 * p) for p in range(7))
    hi = sum(src[p] << (4 * (p - 7)) for p in range(7, MAX_SMEM_NQ))
    return (RELAYOUT, lo, hi, 0)


def unpack_relayout(op) -> Tuple[int, ...]:
    return tuple(((op[1] >> (4 * p)) if p < 7 else
                  (op[2] >> (4 * (p - 7)))) & 15
                 for p in range(MAX_SMEM_NQ))


@dataclasses.dataclass(frozen=True)
class FramePass:
    """One pass of a schedule: its instructions (ops on positions and
    relayouts), the storage bit of each position while the pass loads and
    stores a row (above 14 qubits; the identity below, where a row never
    leaves the chip) and the qubit at each position when the pass ends."""

    ops: Tuple[Tuple[int, int, int, int], ...]
    store: Tuple[int, ...]
    qubit_at: Tuple[int, ...]

    @property
    def relayouts(self) -> int:
        return sum(op[0] == RELAYOUT for op in self.ops)


@dataclasses.dataclass(frozen=True)
class FrameSchedule:
    """How the kernel runs a fused plan at 11-30 qubits: one pass on chip
    (nq ≤ 14), or passes over the row in device memory (nq > 14)."""

    nq: int
    passes: Tuple[FramePass, ...]

    @property
    def relayouts(self) -> int:
        return sum(p.relayouts for p in self.passes)


@functools.lru_cache(maxsize=64)
def frame_schedule(plan: Plan, nq: int) -> FrameSchedule:
    """The schedule of a checked plan at MAX_WARP_NQ < nq ≤ MAX_NQ: the
    plan as :func:`fuse_plan` merges it, on positions.

    Positions 0-4 are register bits, 5-9 lane bits, 10..min(nq, 14)-1
    warp bits and the rest (nq > 14) the bits of a row's chunk in device
    memory. The lanes hold the five qubits that the plan moves most, for
    good; the other qubits start in order of their first moving use. A
    diagonal op (rz, rzz, cz) and a control run at any position; an op
    that moves a bit finds it at a position below 10: when it is at a warp
    position, a relayout first trades the register qubits for the warp
    qubits among the five whose next moving use comes first (greedy,
    furthest next use out); when it is off chip, a new pass starts, whose
    register and warp positions take the nine non-lane qubits whose next
    moving use comes first. A swap moves no data: it trades the two
    qubits' positions.
    """
    if not MAX_WARP_NQ < nq <= MAX_NQ:
        raise ValueError(f"frame_schedule takes {MAX_WARP_NQ} < nq <= "
                         f"{MAX_NQ}, got {nq}")
    ops = fuse_plan(plan)
    chip = min(nq, MAX_SMEM_NQ)
    uses = [[] for _ in range(nq)]
    for i, op in enumerate(ops):
        if _moved(op) >= 0:
            uses[_moved(op)].append(i)
    never = len(ops)

    def next_use(q, i):
        k = bisect.bisect_left(uses[q], i)
        return uses[q][k] if k < len(uses[q]) else never

    lanes = sorted(range(nq), key=lambda q: (-len(uses[q]), q))[:5]
    rest = sorted((q for q in range(nq) if q not in lanes),
                  key=lambda q: (next_use(q, 0), q))
    at = rest[:5] + lanes + rest[5:]                  # position -> qubit
    pos = {q: p for p, q in enumerate(at)}
    # a row's first storage: lanes on bits 0-4 (128-byte runs), registers
    # on bits 5-9, the rest as their positions
    store = ([5, 6, 7, 8, 9, 0, 1, 2, 3, 4] + list(range(10, nq))
             if nq > MAX_SMEM_NQ else list(range(nq)))
    passes, cur = [], []
    for i, op in enumerate(ops):
        kind, a, b, slot = op
        if kind == GATE_SWAP:
            pos[a], pos[b] = pos[b], pos[a]
            at[pos[a]], at[pos[b]] = a, b
            continue
        t = _moved(op)
        if t >= 0 and NEAR <= pos[t] < chip:
            # trade registers for warps: the five soonest move to registers
            pool = [at[p] for p in (*range(5), *range(NEAR, chip))]
            regs = sorted(pool, key=lambda q: (next_use(q, i), pos[q]))[:5]
            out = [p for p in range(5) if at[p] not in regs]
            into = [pos[q] for q in regs if pos[q] >= NEAR]
            src = list(range(MAX_SMEM_NQ))
            for r, w in zip(out, into):
                src[r], src[w] = w, r
                at[r], at[w] = at[w], at[r]
                pos[at[r]], pos[at[w]] = r, w
            cur.append(pack_relayout(src))
        elif t >= 0 and pos[t] >= chip:
            # a new pass: the nine soonest non-lane qubits on chip
            passes.append(FramePass(tuple(cur), tuple(store), tuple(at)))
            bit_of = {at[p]: store[p] for p in range(nq)}
            others = sorted((at[p] for p in range(nq) if p not in LANES),
                            key=lambda q: (next_use(q, i), bit_of[q]))
            off = sorted(others[9:], key=bit_of.get)
            at = others[:5] + at[5:NEAR] + others[5:9] + off
            pos = {q: p for p, q in enumerate(at)}
            store = [bit_of[q] for q in at]
            cur = []
        two = kind in TWO_QUBIT_KINDS
        cur.append((kind, pos[a], pos[b] if two else 0, slot))
    passes.append(FramePass(tuple(cur), tuple(store), tuple(at)))
    return FrameSchedule(nq, tuple(passes))


def _permute_bits(v: torch.Tensor, src: Sequence[int]) -> torch.Tensor:
    """[rows, 2^n] → the same amplitudes with bit p of the new index taken
    from bit ``src[p]`` of the old one."""
    n = len(src)
    dims = [0] + [n - src[n - d] for d in range(1, n + 1)]
    return v.reshape((v.shape[0],) + (2,) * n).permute(dims).reshape(
        v.shape)


def emulate_schedule(theta_eff: torch.Tensor,
                     schedule: FrameSchedule) -> torch.Tensor:
    """The schedule in plain PyTorch, as the kernel runs it: the first
    pass starts at |0…0⟩, each relayout and each pass's load and store is
    a permutation of the index bits, each op runs at its positions, and
    the last pass's P(1) at each position goes to its qubit's column."""
    nq = schedule.nq
    chip = min(nq, MAX_SMEM_NQ)
    plain = _PlainOps(nq, theta_eff.device)
    rows = theta_eff.shape[0]
    re = im = None
    for k, pas in enumerate(schedule.passes):
        if k == 0:
            re, im = _zero_state(rows, nq, theta_eff.device)
        else:                           # load: position p <- storage bit
            re, im = (_permute_bits(v, pas.store) for v in (re, im))
        for op in pas.ops:
            if op[0] == RELAYOUT:
                src = unpack_relayout(op)[:chip] + tuple(range(chip, nq))
                re, im = (_permute_bits(v, src) for v in (re, im))
            else:
                re, im = plain.run(re, im, theta_eff, (op,))
        if k + 1 < len(schedule.passes):    # store: storage bit <- position
            back = [0] * nq
            for p, s in enumerate(pas.store):
                back[s] = p
            re, im = (_permute_bits(v, back) for v in (re, im))
    at_end = plain.marginals(re, im)
    out = torch.empty_like(at_end)
    out[:, list(schedule.passes[-1].qubit_at)] = at_end
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load ``csrc/frame_evolve.cu``."""
    lib = build_library("frame_evolve")
    fn = lib.evolve_frame_marginals_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _pass_rows(nq: int) -> int:
    """Rows a block of the chip tier holds (1 in the pass tier)."""
    return 1 << (MAX_SMEM_NQ - nq) if nq <= MAX_SMEM_NQ else 1


def _slot_range(ops) -> Tuple[int, int]:
    """(first angle slot, number of slots) that a pass's ops read."""
    slots = [op[3] for op in ops if op[0] in ROTATION_KINDS]
    return (min(slots), max(slots) - min(slots) + 1) if slots else (0, 0)


@functools.lru_cache(maxsize=64)
def program(plan: Plan, nq: int) -> Tuple[np.ndarray, np.ndarray]:
    """What the kernel reads at 11-30 qubits: the schedule's passes as
    int32 [records, 4] (each pass: its storage bit and its end qubit of
    each position, a byte each, then its ops) and their records
    int32 [passes, 4] (first record, ops, first angle slot, slots)."""
    records, table = [], []
    for pas in frame_schedule(plan, nq).passes:
        maps = np.zeros(64, np.uint8)
        maps[:nq], maps[32:32 + nq] = pas.store, pas.qubit_at
        table.append((len(records), len(pas.ops), *_slot_range(pas.ops)))
        records.extend(maps.view(np.int32).reshape(_HEADER, 4).tolist())
        records.extend(pas.ops)
    return (np.asarray(records, np.int32).reshape(-1, 4),
            np.asarray(table, np.int32).reshape(-1, 4))


@functools.lru_cache(maxsize=64)
def _plan_tensor(plan: Plan, nq: int, device: torch.device
                 ) -> Tuple[torch.Tensor, np.ndarray]:
    """The int32 [records, 4] tensor the kernel reads on ``device``, and
    the pass records (host; empty at nq ≤ 10, where the kernel reads the
    merged plan itself)."""
    if nq <= MAX_WARP_NQ:
        records = np.asarray(fuse_plan(plan), np.int32).reshape(-1, 4)
        table = np.zeros((0, 4), np.int32)
    else:
        records, table = program(plan, nq)
    return torch.as_tensor(records, device=device), table


def _smem_bytes(nq: int, plan: Plan, n_rot: int) -> int:
    """The most dynamic shared memory a block takes: the merged plan at
    nq ≤ 10 (where the angle table is left out if it does not fit); above,
    for the largest pass, the relayout buffer, the pass's maps and ops and
    the cos/sin of its angles for each row of the block."""
    if nq <= MAX_WARP_NQ:
        return 16 * len(fuse_plan(plan))
    _, table = program(plan, nq)
    return max(_RELAYOUT_BYTES + 16 * (_HEADER + n_ops)
               + 8 * _pass_rows(nq) * n_slots
               for _, n_ops, _, n_slots in table.tolist())


def scratch_slots(nq: int, rows: int) -> int:
    """Row slots of the pass tier (nq > 14): ``_SCRATCH_BYTES`` of rows
    (at least one), the rows of a group that each pass runs over; 0 at
    nq ≤ 14, where a row never leaves the chip."""
    if nq <= MAX_SMEM_NQ:
        return 0
    return max(1, min(rows, _SCRATCH_BYTES // (8 << nq)))


def evolve_frame_marginals(theta_eff: torch.Tensor, plan: Sequence,
                           nq: int) -> torch.Tensor:
    """Frame-basis per-qubit P(1): theta_eff [rows, n_rot] → [rows, nq].

    ``plan`` is the op list: (kind, a, b, theta_slot) per op. Rows whose
    trajectories share a circuit must already have the circuit's angles
    broadcast (sign-folded per trajectory). With no rotation (n_rot = 0)
    the angles are one zero column, as in the JAX package. CPU tensors go
    to :func:`evolve_frame_marginals_reference`; CUDA tensors to the
    kernel, which takes contiguous f32 angles and 1 ≤ nq ≤ 30 on an sm_90
    card: a row in a warp's registers at nq ≤ 10; at 11-14 rows in a
    block's registers (:func:`frame_schedule`'s one pass); above 14 each
    row in a slot of a scratch buffer in device memory
    (:func:`scratch_slots`), a launch a pass of the schedule. One launch
    is counted a call.
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
    if _smem_bytes(nq, plan, n_rot) > _MAX_SMEM_BYTES:
        raise ValueError(f"a plan of {len(plan)} ops and {n_rot} angles at "
                         f"nq={nq} exceeds the kernel's shared memory")
    if torch.cuda.get_device_capability(device) != (9, 0):
        raise RuntimeError("the kernel is built for sm_90a; "
                           f"{torch.cuda.get_device_name(device)} is not")
    out = torch.empty((rows, nq), dtype=torch.float32, device=device)
    if rows == 0:
        return out
    prog, table = _plan_tensor(plan, nq, device)
    slots = scratch_slots(nq, rows)
    scratch = torch.empty((slots, 1 << nq, 2) if slots else (0,),
                          dtype=torch.float32, device=device)
    partials = torch.empty(
        (slots, 1 << (nq - MAX_SMEM_NQ), nq) if slots else (0,),
        dtype=torch.float32, device=device)
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.evolve_frame_marginals_launch(
            theta_eff.data_ptr(), prog.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), partials.data_ptr(),
            table.ctypes.data_as(ctypes.c_void_p), slots, rows, nq,
            prog.shape[0], n_rot, table.shape[0],
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"evolve_frame_marginals kernel launch failed: "
                           f"CUDA error {err}")
    evolve_frame_marginals.launches += 1
    return out


# kernel launches since the last reset (set it to 0 to reset)
evolve_frame_marginals.launches = 0
