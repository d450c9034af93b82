"""Fused kicked-Ising evolution: the CUDA kernel's wrapper and its plain
PyTorch version.

:func:`evolve_fused` takes the same inputs as the JAX package's
``ops/pallas/evolve.py::evolve_fused``. On CUDA tensors it launches the
hand-written kernel of ``csrc/evolve.cu`` (built with ``nvcc`` at first use)
on the current stream, or raises; on CPU tensors it runs
:func:`evolve_fused_reference`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from ...utils.build import build_library

MAX_NQ = 13
_MAX_SMEM_BYTES = 232448      # per-block shared memory on sm_90
_INV_SQRT2 = float(np.float32(1.0 / np.sqrt(2.0)))


def wht(state: torch.Tensor, nq: int) -> torch.Tensor:
    """H⊗nq over the last amplitude axis [..., 2^n] (n butterfly passes)."""
    batch = state.shape[:-1]
    dim = state.shape[-1]
    for q in range(nq):
        v = state.reshape(batch + (dim // (2 ** (q + 1)), 2, 2 ** q))
        a, b = v[..., 0, :], v[..., 1, :]
        state = torch.stack(((a + b) * _INV_SQRT2, (a - b) * _INV_SQRT2),
                            dim=-2).reshape(batch + (dim,))
    return state


def evolve_fused_reference(re, im, kick_signs, bond_signs, theta_j_col,
                           bit_pm_t, bond_par_t, theta_h: float, steps: int,
                           nq: int, nb: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: butterfly WHTs and phases."""
    for s in range(steps):
        kick_s = kick_signs[:, s * nq:(s + 1) * nq]
        bond_s = bond_signs[:, s * nb:(s + 1) * nb]
        re, im = wht(re, nq), wht(im, nq)
        expo = (theta_h / 2.0) * (kick_s @ bit_pm_t)
        c, sn = torch.cos(expo), torch.sin(expo)
        re, im = re * c - im * sn, re * sn + im * c
        re, im = wht(re, nq), wht(im, nq)
        expo2 = (-0.5 * theta_j_col) * (bond_s @ bond_par_t)
        c, sn = torch.cos(expo2), torch.sin(expo2)
        re, im = re * c - im * sn, re * sn + im * c
    return re, im


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load ``csrc/evolve.cu``."""
    lib = build_library("evolve")
    fn = lib.evolve_fused_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(t: torch.Tensor, name: str, shape, device: torch.device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, re is on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def evolve_fused(re, im, kick_signs, bond_signs, theta_j_col, bit_pm_t,
                 bond_par_t, theta_h: float, steps: int, nq: int, nb: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full evolution: re/im [rows, 2^nq] → evolved planes.

    kick_signs [rows, steps·nq]; bond_signs [rows, steps·nb];
    theta_j_col [rows, 1]; bit_pm_t [nq, dim] and bond_par_t [nb, dim]
    hold ±1 (the kernel writes NaN everywhere if they hold anything else).
    All f32 and contiguous. CPU tensors go to
    :func:`evolve_fused_reference`; CUDA tensors to the kernel, which
    takes 1 ≤ nq ≤ 13 and nb ≤ 32 on an sm_90 card.
    """
    device = re.device
    if device.type == "cpu":
        return evolve_fused_reference(re, im, kick_signs, bond_signs,
                                      theta_j_col, bit_pm_t, bond_par_t,
                                      theta_h, steps, nq, nb)
    if device.type != "cuda":
        raise ValueError(f"evolve_fused runs on cpu or cuda, not {device}")
    if not 1 <= nq <= MAX_NQ:
        raise ValueError(f"the kernel takes 1 <= nq <= {MAX_NQ}, got {nq}")
    if not 0 <= nb <= 32:
        raise ValueError(f"the kernel takes 0 <= nb <= 32, got {nb}")
    dim = 2 ** nq
    if 4 * (4 * dim + steps * (nq + nb)) > _MAX_SMEM_BYTES:
        raise ValueError(f"steps={steps} at nq={nq} exceeds the kernel's "
                         "shared memory")
    if torch.cuda.get_device_capability(device) != (9, 0):
        raise RuntimeError("the kernel is built for sm_90a; "
                           f"{torch.cuda.get_device_name(device)} is not")
    rows = re.shape[0]
    _check(re, "re", (rows, dim), device)
    _check(im, "im", (rows, dim), device)
    _check(kick_signs, "kick_signs", (rows, steps * nq), device)
    _check(bond_signs, "bond_signs", (rows, steps * nb), device)
    _check(theta_j_col, "theta_j_col", (rows, 1), device)
    _check(bit_pm_t, "bit_pm_t", (nq, dim), device)
    _check(bond_par_t, "bond_par_t", (nb, dim), device)
    re_out = torch.empty_like(re)
    im_out = torch.empty_like(im)
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.evolve_fused_launch(
            re.data_ptr(), im.data_ptr(), kick_signs.data_ptr(),
            bond_signs.data_ptr(), theta_j_col.data_ptr(),
            bit_pm_t.data_ptr(), bond_par_t.data_ptr(), re_out.data_ptr(),
            im_out.data_ptr(), rows, nq, nb, steps, float(theta_h),
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"evolve_fused kernel launch failed: CUDA error "
                           f"{err}")
    evolve_fused.launches += 1
    return re_out, im_out


# kernel launches since the last reset (set it to 0 to reset)
evolve_fused.launches = 0
