"""Walsh–Hadamard transform over re/im planes: the CUDA kernel's wrapper and
its plain PyTorch version.

:func:`wht_planes` is the counterpart of the JAX package's
``ops/pallas/wht.py::wht_pallas_planes``: H⊗nq on every row of the re and
im planes [rows, 2^nq]. On CUDA tensors it launches the hand-written kernel
of ``csrc/wht.cu`` (built with ``nvcc`` at first use) on the current stream,
or raises; on CPU tensors it runs :func:`wht_planes_reference`. It works IN
PLACE (the JAX function returns new arrays): at the light-cone engine's
2^21-amplitude windows a state block is 2 GB, and a second copy is what
this saves.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from ...utils.build import build_library

MAX_NQ = 30
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


def hadamard_dense(nq: int) -> np.ndarray:
    """Dense ±1/√2^n Hadamard [2^n, 2^n] float32 (host constant)."""
    h = np.array([[1.0]], dtype=np.float64)
    for _ in range(nq):
        h = np.block([[h, h], [h, -h]])
    return (h / np.sqrt(2.0 ** nq)).astype(np.float32)


def check_ieee_matmul(t: torch.Tensor):
    """Raise if a float32 matmul on ``t``'s device would run in TF32: the
    matmul forms of the WHT multiply by ±1/√d, and the kicked engine's ⟨Z⟩
    sums probabilities, both of which TF32 rounds to 10 mantissa bits."""
    if t.device.type == "cuda" and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("this matmul must run at IEEE f32, and TF32 is "
                           "enabled for float32 matmuls")


def wht_planes_reference(re: torch.Tensor, im: torch.Tensor, nq: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the butterfly :func:`wht` of
    each plane, as new tensors."""
    return wht(re, nq), wht(im, nq)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load ``csrc/wht.cu``."""
    lib = build_library("wht")
    fn = lib.wht_planes_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def wht_planes(re: torch.Tensor, im: torch.Tensor, nq: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """H⊗nq on every row of re and im [rows, 2^nq] f32, in place; returns
    (re, im).

    CPU tensors go to :func:`wht_planes_reference` (its result is copied
    back). CUDA tensors go to the kernel, which takes contiguous, distinct,
    16-byte aligned f32 planes of any row count and 1 ≤ nq ≤ 30 on an
    sm_90 card.
    """
    device = re.device
    if device.type == "cpu":
        new_re, new_im = wht_planes_reference(re, im, nq)
        return re.copy_(new_re), im.copy_(new_im)
    if device.type != "cuda":
        raise ValueError(f"wht_planes runs on cpu or cuda, not {device}")
    if not 1 <= nq <= MAX_NQ:
        raise ValueError(f"the kernel takes 1 <= nq <= {MAX_NQ}, got {nq}")
    if torch.cuda.get_device_capability(device) != (9, 0):
        raise RuntimeError("the kernel is built for sm_90a; "
                           f"{torch.cuda.get_device_name(device)} is not")
    for name, t in (("re", re), ("im", im)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, re is on {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 2 or t.shape[1] != 2 ** nq or t.shape != re.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"({re.shape[0]}, {2 ** nq})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             "copies float4)")
    if re.data_ptr() == im.data_ptr() and re.numel():
        raise ValueError("re and im must be distinct tensors")
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.wht_planes_launch(
            re.data_ptr(), im.data_ptr(), re.shape[0], nq,
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wht_planes kernel launch failed: CUDA error "
                           f"{err}")
    wht_planes.launches += 1
    return re, im


# kernel launches since the last reset (set it to 0 to reset)
wht_planes.launches = 0


def wht_fused(state: torch.Tensor, nq: int) -> torch.Tensor:
    """Drop-in for :func:`wht` on [..., 2^nq] complex64 states, through
    :func:`wht_planes` (the JAX package's ``wht.py::wht_fused``)."""
    batch = state.shape[:-1]
    dim = state.shape[-1]
    re = state.real.reshape(-1, dim).contiguous()
    im = state.imag.reshape(-1, dim).contiguous()
    re, im = wht_planes(re, im, nq)
    return torch.complex(re, im).reshape(batch + (dim,))
