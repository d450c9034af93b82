"""The kicked-Ising frame pass (K5): the CUDA kernel's wrapper and its plain
PyTorch version.

:func:`propagate_frames` commutes the drawn noise Paulis of every trajectory
to the end of the circuit: the pass of the JAX package's
``KickedIsingEngine._frame_signs`` (a ``lax.scan``), which the port's
kicked-Ising and light-cone engines both run. On CUDA tensors it launches
the hand-written kernel of ``csrc/propagate_frames.cu`` (built with ``nvcc``
at first use) on the current stream, one launch a pass, or raises; on CPU
tensors it runs :func:`propagate_frames_reference`, the same walk as int32
torch ops over all rows, a bond at a time.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from ...utils.build import build_library

MAX_NQ = 31     # the frame's bit masks are int32
# the kernel's shared memory holds a block's draws and signs of one step
MAX_BONDS = 128


def propagate_frames_reference(draws: torch.Tensor,
                               bonds: Sequence[Tuple[int, int]], nq: int
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Plain PyTorch version of the kernel (:func:`propagate_frames`)."""
    S, rows, nb, _ = draws.shape
    pa, pb = draws // 4, draws % 4
    a_idx = torch.tensor([a for a, _ in bonds], dtype=torch.int32,
                         device=draws.device)[:, None]
    b_idx = torch.tensor([b for _, b in bonds], dtype=torch.int32,
                         device=draws.device)[:, None]
    # pauli code p (0..3 per qubit): x-part p∈{1,2}, z-part p∈{2,3}
    noise_x = ((((pa == 1) | (pa == 2)).int() << a_idx)
               | (((pb == 1) | (pb == 2)).int() << b_idx))
    noise_z = ((((pa == 2) | (pa == 3)).int() << a_idx)
               | (((pb == 2) | (pb == 3)).int() << b_idx))
    del pa, pb
    qs = torch.arange(nq, dtype=torch.int32, device=draws.device)
    x = torch.zeros(rows, dtype=torch.int32, device=draws.device)
    z = torch.zeros_like(x)
    kick = torch.empty((rows, S, nq), dtype=torch.float32,
                       device=draws.device)
    bond = torch.empty((rows, S, nb), dtype=torch.float32,
                       device=draws.device)
    x_after = torch.empty((S, rows), dtype=torch.int32, device=draws.device)
    for s in range(S):
        # rx(θh) on every qubit flips iff the frame has Z/Y there
        kick[:, s] = 1 - 2 * ((z[:, None] >> qs) & 1)
        for k, (a, b) in enumerate(bonds):
            # first CX(a, b): X_a → X_a X_b, Z_b → Z_a Z_b; then noise
            x ^= ((x >> a) & 1) << b
            z ^= ((z >> b) & 1) << a
            x ^= noise_x[s, :, k, 0]
            z ^= noise_z[s, :, k, 0]
            # rz(θJ) on target b flips iff the frame has X/Y on b
            bond[:, s, k] = 1 - 2 * ((x >> b) & 1)
            # second CX(a, b) and its noise
            x ^= ((x >> a) & 1) << b
            z ^= ((z >> b) & 1) << a
            x ^= noise_x[s, :, k, 1]
            z ^= noise_z[s, :, k, 1]
        x_after[s] = x
    return kick, bond, x_after


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load ``csrc/propagate_frames.cu``."""
    lib = build_library("propagate_frames")
    fn = lib.propagate_frames_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=64)
def _bond_table(bonds: Tuple[Tuple[int, int], ...],
                device: torch.device) -> torch.Tensor:
    """The bond list as int32 (a, b) pairs [nb, 2] on ``device``, made once
    per list: the engines pass the same few lists on every call."""
    return torch.tensor(bonds, dtype=torch.int32,
                        device=device).reshape(len(bonds), 2)


def _check(draws: torch.Tensor, bonds: Tuple[Tuple[int, int], ...],
           nq: int):
    if draws.dtype != torch.int32:
        raise TypeError(f"draws must be int32, got {draws.dtype}")
    if draws.dim() != 4 or draws.shape[2:] != (len(bonds), 2):
        raise ValueError(f"draws has shape {tuple(draws.shape)}, expected "
                         f"(steps, rows, {len(bonds)}, 2)")
    if not draws.is_contiguous():
        raise ValueError("draws must be contiguous")
    if not 1 <= nq <= MAX_NQ:
        raise ValueError(f"the frame pass takes 1 <= nq <= {MAX_NQ}, "
                         f"got {nq}")
    if len(bonds) > MAX_BONDS:
        raise ValueError(f"the frame pass takes at most {MAX_BONDS} bonds, "
                         f"got {len(bonds)}")
    for a, b in bonds:
        if not (0 <= a < nq and 0 <= b < nq):
            raise ValueError(f"bond ({a}, {b}) leaves the {nq} qubits")


def _launch(draws: torch.Tensor, bonds: Tuple[Tuple[int, int], ...],
            nq: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of the kernel on checked CUDA draws."""
    device = draws.device
    if torch.cuda.get_device_capability(device) != (9, 0):
        raise RuntimeError("the kernel is built for sm_90a; "
                           f"{torch.cuda.get_device_name(device)} is not")
    if draws.data_ptr() % 8:
        raise ValueError("draws must be 8-byte aligned (the kernel reads a "
                         "bond's two draws as one int2)")
    S, rows, nb, _ = draws.shape
    table = _bond_table(bonds, device)
    kick = torch.empty((rows, S, nq), dtype=torch.float32, device=device)
    bond = torch.empty((rows, S, nb), dtype=torch.float32, device=device)
    x_after = torch.empty((S, rows), dtype=torch.int32, device=device)
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.propagate_frames_launch(
            draws.data_ptr(), table.data_ptr(), kick.data_ptr(),
            bond.data_ptr(), x_after.data_ptr(), rows, S, nb, nq,
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"propagate_frames kernel launch failed: CUDA "
                           f"error {err}")
    return kick, bond, x_after


def propagate_frames(draws: torch.Tensor, bonds: Sequence[Tuple[int, int]],
                     nq: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Commute the drawn noise Paulis to the end of the circuit.

    draws int32 [steps, rows, n_bonds, 2], contiguous: the Pauli 4·p_a +
    p_b after each of a bond's two CX, bonds (a, b) in application order,
    qubits in [0, nq), nq ≤ 31. Returns f32 ±1 kick signs [rows, steps,
    nq] (each step's RX flips where the frame has Z/Y), bond signs [rows,
    steps, n_bonds] (a bond's RZ flips where the frame has X/Y on its
    target) and the frame's int32 X mask after each step [steps, rows].
    The frame is int32 X and Z bit masks over the qubits.

    The arguments are checked first, on any device. CPU tensors then go to
    :func:`propagate_frames_reference`; CUDA tensors to the kernel, on an
    sm_90 card, one launch counted in ``propagate_frames.launches``.
    """
    bonds = tuple((int(a), int(b)) for a, b in bonds)
    _check(draws, bonds, nq)
    if draws.device.type == "cpu":
        return propagate_frames_reference(draws, bonds, nq)
    if draws.device.type != "cuda":
        raise ValueError(f"propagate_frames runs on cpu or cuda, not "
                         f"{draws.device}")
    out = _launch(draws, bonds, nq)
    propagate_frames.launches += 1
    return out


# kernel launches since the last reset (set it to 0 to reset)
propagate_frames.launches = 0
