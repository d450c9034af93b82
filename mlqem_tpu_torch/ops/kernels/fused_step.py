"""One kicked-Ising Trotter step: the CUDA kernel's wrapper, its plain
PyTorch version, and the radix-split WHT.

:func:`fused_trotter_step` takes the same inputs as the JAX package's
``ops/pallas/fused_step.py::fused_trotter_step``, less the TPU's matrix-unit
tiling (``A``, ``L``, ``block_rows``, ``interpret``): one step of WHT, RX
phase, WHT, ZZ phase on re/im planes [rows, 2^nq], with the ±1 tables in
the JAX layout (``bit_pm`` [2^nq, nq], ``bond_par`` [2^nq, nb]). On CUDA
tensors it launches the hand-written kernel of ``csrc/fused_step.cu``
(built with ``nvcc`` at first use) on the current stream, or raises; on CPU
tensors it runs :func:`fused_trotter_step_reference`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ...utils.build import build_library
from .evolve import _check, evolve_fused_reference
from .wht import check_ieee_matmul, hadamard_dense

# at nq=14 the block's exchange buffer and packed sign masks take 198 KB of
# shared memory, of the 227 KB a block may use on sm_90
MAX_NQ = 14
MAX_NB = 16


def wht_radix(state: torch.Tensor, nq: int, lane_pow: int = 7
              ) -> torch.Tensor:
    """H⊗nq over [..., 2^nq] as two dense Hadamard matmuls, at IEEE f32.

    The state viewed as [A, L] (L = 2^min(lane_pow, nq)) holds the low bits
    on the lane axis and the high bits on the block axis, so
    (H_A ⊗ I)·(I ⊗ H_L) is H⊗nq in the butterfly's bit convention. Complex
    states take two real matmuls per factor (H is real).
    """
    check_ieee_matmul(state)
    lane_pow = min(lane_pow, nq)
    h_hi = torch.as_tensor(hadamard_dense(nq - lane_pow), device=state.device)
    h_lo = torch.as_tensor(hadamard_dense(lane_pow), device=state.device)
    batch = state.shape[:-1]

    def real_pass(x):
        v = x.reshape(batch + (h_hi.shape[0], h_lo.shape[0]))
        return (h_hi @ (v @ h_lo)).reshape(x.shape)

    if state.is_complex():
        return torch.complex(real_pass(state.real), real_pass(state.imag))
    return real_pass(state)


def fused_trotter_step_reference(re, im, kick_signs, bond_signs, theta_j_col,
                                 bit_pm, bond_par, theta_h: float
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: one step of
    :func:`~.evolve.evolve_fused_reference`."""
    nq, nb = kick_signs.shape[1], bond_signs.shape[1]
    return evolve_fused_reference(re, im, kick_signs, bond_signs, theta_j_col,
                                  bit_pm.T, bond_par.T, theta_h, 1, nq, nb)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load ``csrc/fused_step.cu``."""
    lib = build_library("fused_step")
    fn = lib.fused_trotter_step_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def fused_trotter_step(re, im, kick_signs, bond_signs, theta_j_col, bit_pm,
                       bond_par, theta_h: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Trotter step: re/im [rows, 2^nq] → new planes.

    kick_signs [rows, nq]; bond_signs [rows, nb]; theta_j_col [rows, 1];
    bit_pm [2^nq, nq] and bond_par [2^nq, nb] hold ±1 (the kernel writes
    NaN everywhere if they hold anything else). All f32 and contiguous. CPU
    tensors go to :func:`fused_trotter_step_reference`; CUDA tensors to the
    kernel, which takes 1 ≤ nq ≤ 14 and nb ≤ 16 on an sm_90 card.
    """
    device = re.device
    if device.type == "cpu":
        return fused_trotter_step_reference(re, im, kick_signs, bond_signs,
                                            theta_j_col, bit_pm, bond_par,
                                            theta_h)
    if device.type != "cuda":
        raise ValueError(f"fused_trotter_step runs on cpu or cuda, not "
                         f"{device}")
    nq, nb = kick_signs.shape[-1], bond_signs.shape[-1]
    if not 1 <= nq <= MAX_NQ:
        raise ValueError(f"the kernel takes 1 <= nq <= {MAX_NQ}, got {nq}")
    if not 0 <= nb <= MAX_NB:
        raise ValueError(f"the kernel takes 0 <= nb <= {MAX_NB}, got {nb}")
    if torch.cuda.get_device_capability(device) != (9, 0):
        raise RuntimeError("the kernel is built for sm_90a; "
                           f"{torch.cuda.get_device_name(device)} is not")
    rows, dim = re.shape[0], 2 ** nq
    _check(re, "re", (rows, dim), device)
    _check(im, "im", (rows, dim), device)
    _check(kick_signs, "kick_signs", (rows, nq), device)
    _check(bond_signs, "bond_signs", (rows, nb), device)
    _check(theta_j_col, "theta_j_col", (rows, 1), device)
    _check(bit_pm, "bit_pm", (dim, nq), device)
    _check(bond_par, "bond_par", (dim, nb), device)
    re_out = torch.empty_like(re)
    im_out = torch.empty_like(im)
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.fused_trotter_step_launch(
            re.data_ptr(), im.data_ptr(), kick_signs.data_ptr(),
            bond_signs.data_ptr(), theta_j_col.data_ptr(), bit_pm.data_ptr(),
            bond_par.data_ptr(), re_out.data_ptr(), im_out.data_ptr(), rows,
            nq, nb, float(theta_h),
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_trotter_step kernel launch failed: CUDA "
                           f"error {err}")
    fused_trotter_step.launches += 1
    return re_out, im_out


# kernel launches since the last reset (set it to 0 to reset)
fused_trotter_step.launches = 0
