"""One kicked-Ising Trotter step: the CUDA kernels' wrapper, its plain
PyTorch version, a plain emulation of the wide tier's passes, and the
radix-split WHT.

:func:`fused_trotter_step` takes the same inputs as the JAX package's
``ops/pallas/fused_step.py::fused_trotter_step``, less the TPU's matrix-unit
tiling (``A``, ``L``, ``block_rows``, ``interpret``): one step of WHT, RX
phase, WHT, ZZ phase on re/im planes [rows, 2^nq], with the ±1 tables in
the JAX layout (``bit_pm`` [2^nq, nq], ``bond_par`` [2^nq, nb]). On CUDA
tensors it launches a hand-written kernel (built with ``nvcc`` at first
use) on the current stream, or raises: ``csrc/fused_step.cu`` at nq ≤ 14,
where a row stays on chip, and ``csrc/fused_step_wide.cu`` at nq 15-30,
which runs the step in passes over device memory with the phases inside
the passes (:func:`fused_trotter_step_passes` emulates them). On CPU
tensors it runs :func:`fused_trotter_step_reference`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from ...utils.build import build_library
from .evolve import _check, evolve_fused_reference
from .wht import _INV_SQRT2, check_ieee_matmul, hadamard_dense

# at nq=14 the chip tier's exchange buffer and packed sign masks take 198 KB
# of shared memory, of the 227 KB a block may use on sm_90
MAX_CHIP_NQ = 14
MAX_CHIP_NB = 16
# the wide tier: masks of 32 bits, at most three high groups of 8 bits
MAX_NQ = 30
MAX_NB = 32
TILE_BITS = 13          # the wide tier's tile: 2^13 amplitudes of both planes
COL_BITS = 5            # a high pass's tile bits 0-4: contiguous amplitudes


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


def step_masks_reference(bit_pm: torch.Tensor, bond_par: torch.Tensor
                         ) -> torch.Tensor:
    """Plain version of :func:`step_masks`: the per-amplitude sign masks of
    the ±1 tables, int32 [2·2^w + 1]."""
    dim, w = bit_pm.shape
    nb = bond_par.shape[1]

    def words(table, n):
        shifts = torch.arange(n, device=table.device)
        return ((table < 0).to(torch.int64) << shifts).sum(dim=1)

    def signs(table):
        return ((table == 1.0) | (table == -1.0)).all()

    bad = (~(signs(bit_pm) & signs(bond_par))).to(torch.int64).reshape(1)
    out = torch.cat([words(bit_pm, w), words(bond_par, nb), bad])
    # words of up to 32 bits, kept as int32 bit patterns
    return (out - ((out >> 31) << 32)).to(torch.int32)


def high_groups(w: int, tile_bits: int = TILE_BITS) -> List[Tuple[int, int]]:
    """(lo, k) of each high pass of the wide tier at width w: amplitude bits
    lo..lo+k-1, ⌈(w − tile_bits)/(tile_bits − 5)⌉ groups of nearly
    equal size above the low pass's bits 0..tile_bits-1."""
    per, high = tile_bits - COL_BITS, w - tile_bits
    if per < 1 or high < 1:
        raise ValueError(f"the wide tier takes w > tile_bits > {COL_BITS}, "
                         f"got w={w}, tile_bits={tile_bits}")
    n = -(-high // per)
    groups, lo = [], tile_bits
    for i in range(n):
        k = high // n + (1 if i < high % n else 0)
        groups.append((lo, k))
        lo += k
    return groups


def _tile_amplitudes(w: int, lo: int, k: int, tile_bits: int
                     ) -> torch.Tensor:
    """[2^(w − tile_bits), 2^tile_bits]: the amplitude of a row at element
    idx of the row's tile g, as the kernel's ``tile_origin`` and ``element``
    place it. lo = 0: the low pass (tile bits = amplitude bits); else tile
    bits 5..4+k hold amplitude bits lo..lo+k-1, and tile bits 0-4 and
    5+k.. the contiguous amplitude bits 0..tile_bits-k-1."""
    g = torch.arange(2 ** (w - tile_bits))[:, None]
    idx = torch.arange(2 ** tile_bits)[None, :]
    if lo == 0:
        return (g << tile_bits) | idx
    cb = tile_bits - k
    mid = lo - cb
    origin = ((g >> mid) << (lo + k)) | ((g & ((1 << mid) - 1)) << cb)
    rho = idx >> COL_BITS
    col = ((rho >> k) << COL_BITS) | (idx & ((1 << COL_BITS) - 1))
    return origin | ((rho & ((1 << k) - 1)) << lo) | col


def _butterflies(t: torch.Tensor, bits) -> torch.Tensor:
    """The plain butterfly's stages ((a + b)/√2, (a − b)/√2 in f32) over
    the given bits of the last axis."""
    shape, n = t.shape, t.shape[-1]
    for b in bits:
        v = t.reshape(shape[:-1] + (n >> (b + 1), 2, 1 << b))
        lo, hi = v[..., 0, :], v[..., 1, :]
        t = torch.stack(((lo + hi) * _INV_SQRT2, (lo - hi) * _INV_SQRT2),
                        dim=-2).reshape(shape)
    return t


def _popcount(x: torch.Tensor) -> torch.Tensor:
    return sum((x >> b) & 1 for b in range(32))


def _tile_phase(re, im, words, signs, scale):
    """The phase of the kernel's tiles: re/im [rows, G, T], words [G, T]
    (the tile's masks), signs [rows, n] ±1 per row, scale [rows]. Rows whose
    signs are all ±1 take their table of n + 1 cos/sin values through
    popcount(mask ^ neg); the others sum their signs per amplitude."""
    rows, n = signs.shape
    shifts = torch.arange(n)
    neg = ((signs < 0).to(torch.int64) << shifts).sum(dim=1)
    ok = ((signs == 1.0) | (signs == -1.0)).all(dim=1)
    m = torch.arange(n + 1, dtype=torch.float32)
    angle = scale[:, None] * (float(n) - 2.0 * m)
    at = _popcount(words[None] ^ neg[:, None, None]).reshape(rows, -1)
    c = torch.gather(torch.cos(angle), 1, at).reshape(re.shape)
    s = torch.gather(torch.sin(angle), 1, at).reshape(re.shape)
    if not bool(ok.all()):
        flips = 1.0 - 2.0 * ((words[..., None] >> shifts) & 1).float()
        for r in torch.nonzero(~ok).flatten().tolist():
            dot = (flips * signs[r]).sum(dim=-1)
            c[r] = torch.cos(scale[r] * dot)
            s[r] = torch.sin(scale[r] * dot)
    return re * c - im * s, re * s + im * c


def fused_trotter_step_passes(re, im, kick_signs, bond_signs, theta_j_col,
                              bit_pm, bond_par, theta_h: float,
                              tile_bits: int = TILE_BITS,
                              masks: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The wide tier's passes in plain torch (the tests' emulation; nothing
    on the main path calls it).

    Each pass gathers a row's tiles of 2^tile_bits amplitudes as the kernel
    places them, transforms its tile bits with the plain butterfly's stages
    and scatters them back: the low pass (bits 0..tile_bits-1) from the
    inputs, the high groups of :func:`high_groups` but the last, the last
    group with the RX phase between its two transforms, the other groups
    in reverse, and the low pass with the ZZ phase. The phases use the
    masks of :func:`step_masks_reference` and per-row tables as the kernel
    does; a table entry other than ±1 makes every output NaN.
    ``tile_bits`` below 13 gives small widths one to three high passes.
    Given ``masks``, the tables may be None, as in
    :func:`fused_trotter_step`.
    """
    rows, dim = re.shape
    w = kick_signs.shape[1]
    groups = high_groups(w, tile_bits)
    if masks is None:
        masks = step_masks_reference(bit_pm, bond_par)
    if int(masks[2 * dim]):
        nan = torch.full_like(re, float("nan"))
        return nan, nan.clone()
    words = masks[:2 * dim].to(torch.int64) & 0xFFFFFFFF
    rx_scale = torch.full((rows,), 0.5 * float(np.float32(theta_h)))
    zz_scale = -0.5 * theta_j_col[:, 0]
    rx = (kick_signs, rx_scale, words[:dim])
    zz = (bond_signs, zz_scale, words[dim:])
    low = (0, tile_bits)
    order = ([(low, None, False)] + [(g, None, False) for g in groups[:-1]]
             + [(groups[-1], rx, True)]
             + [(g, None, False) for g in reversed(groups[:-1])]
             + [(low, zz, False)])
    for (lo, k), phase, twice in order:
        at = _tile_amplitudes(w, lo, k, tile_bits)
        flat = at.reshape(-1)
        bits = range(tile_bits) if lo == 0 else range(COL_BITS, COL_BITS + k)
        t_re = _butterflies(re[:, flat].reshape(rows, *at.shape), bits)
        t_im = _butterflies(im[:, flat].reshape(rows, *at.shape), bits)
        if phase is not None:
            signs, scale, table = phase
            t_re, t_im = _tile_phase(t_re, t_im, table[at], signs, scale)
        if twice:
            t_re, t_im = _butterflies(t_re, bits), _butterflies(t_im, bits)
        re, im = torch.empty_like(re), torch.empty_like(im)
        re[:, flat] = t_re.reshape(rows, -1)
        im[:, flat] = t_im.reshape(rows, -1)
    return re, im


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


@functools.lru_cache(maxsize=None)
def load_wide_library() -> ctypes.CDLL:
    """Build (once per source version) and load ``csrc/fused_step_wide.cu``."""
    lib = build_library("fused_step_wide")
    fn = lib.fused_trotter_step_wide_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.step_masks_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _on_card(device: torch.device, name: str):
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {device}")
    if torch.cuda.get_device_capability(device) != (9, 0):
        raise RuntimeError("the kernel is built for sm_90a; "
                           f"{torch.cuda.get_device_name(device)} is not")


def step_masks(bit_pm: torch.Tensor, bond_par: torch.Tensor
               ) -> torch.Tensor:
    """The wide tier's per-amplitude masks of the ±1 tables bit_pm [2^w, w]
    and bond_par [2^w, nb]: int32 [2·2^w + 1], bit q of word j set where
    bit_pm[j, q] < 0, bit k of word 2^w + j where bond_par[j, k] < 0, and
    a last word of 1 if any entry is not ±1.

    Built once per table pair (``kicked_steps`` builds them once a call)
    and handed to :func:`fused_trotter_step` as ``masks``. CPU tensors go
    to :func:`step_masks_reference`; CUDA tensors to the kernel of
    ``csrc/fused_step_wide.cu``, which takes 1 ≤ w ≤ 30 and nb ≤ 32.
    """
    device = bit_pm.device
    if device.type == "cpu":
        return step_masks_reference(bit_pm, bond_par)
    _on_card(device, "step_masks")
    dim, w = bit_pm.shape
    nb = bond_par.shape[1]
    if not 1 <= w <= MAX_NQ or dim != 2 ** w:
        raise ValueError(f"the kernel takes bit_pm [2^w, w] with 1 <= w <= "
                         f"{MAX_NQ}, got {tuple(bit_pm.shape)}")
    if not 0 <= nb <= MAX_NB:
        raise ValueError(f"the kernel takes 0 <= nb <= {MAX_NB}, got {nb}")
    _check(bit_pm, "bit_pm", (dim, w), device)
    _check(bond_par, "bond_par", (dim, nb), device)
    masks = torch.empty(2 * dim + 1, dtype=torch.int32, device=device)
    lib = load_wide_library()
    with torch.cuda.device(device):
        err = lib.step_masks_launch(
            bit_pm.data_ptr(), bond_par.data_ptr(), w, nb, masks.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"step_masks kernel launch failed: CUDA error "
                           f"{err}")
    step_masks.launches += 1
    return masks


# kernel launches since the last reset (set it to 0 to reset)
step_masks.launches = 0


def fused_trotter_step(re, im, kick_signs, bond_signs, theta_j_col, bit_pm,
                       bond_par, theta_h: float,
                       masks: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Trotter step: re/im [rows, 2^nq] → new planes.

    kick_signs [rows, nq]; bond_signs [rows, nb]; theta_j_col [rows, 1];
    bit_pm [2^nq, nq] and bond_par [2^nq, nb] hold ±1 (the kernels write
    NaN everywhere if they hold anything else). All f32 and contiguous. CPU
    tensors go to :func:`fused_trotter_step_reference` (without tables, to
    :func:`fused_trotter_step_passes`); CUDA tensors to a kernel on an
    sm_90 card: the chip tier at 1 ≤ nq ≤ 14 with nb ≤ 16, the
    wide tier at nq 15-30 with nb ≤ 32 (16-byte aligned planes). ``masks``
    are :func:`step_masks` of the tables, which the wide tier builds itself
    when not given; given masks, the wide tier reads no table, and bit_pm
    and bond_par may be None (from 28 qubits the tables, 2^nq·(nq + nb)·4
    bytes, outgrow an 80 GB card). One call counts one launch, whatever
    its passes.
    """
    device = re.device
    if device.type == "cpu":
        if bit_pm is None or bond_par is None:
            return fused_trotter_step_passes(re, im, kick_signs, bond_signs,
                                             theta_j_col, None, None,
                                             theta_h, masks=masks)
        return fused_trotter_step_reference(re, im, kick_signs, bond_signs,
                                            theta_j_col, bit_pm, bond_par,
                                            theta_h)
    if device.type != "cuda":
        raise ValueError(f"fused_trotter_step runs on cpu or cuda, not "
                         f"{device}")
    nq, nb = kick_signs.shape[-1], bond_signs.shape[-1]
    if not 1 <= nq <= MAX_NQ:
        raise ValueError(f"the kernel takes 1 <= nq <= {MAX_NQ}, got {nq}")
    chip = nq <= MAX_CHIP_NQ
    max_nb = MAX_CHIP_NB if chip else MAX_NB
    if not 0 <= nb <= max_nb:
        raise ValueError(f"the kernel takes 0 <= nb <= {max_nb} at nq={nq}, "
                         f"got {nb}")
    _on_card(device, "fused_trotter_step")
    rows, dim = re.shape[0], 2 ** nq
    _check(re, "re", (rows, dim), device)
    _check(im, "im", (rows, dim), device)
    _check(kick_signs, "kick_signs", (rows, nq), device)
    _check(bond_signs, "bond_signs", (rows, nb), device)
    _check(theta_j_col, "theta_j_col", (rows, 1), device)
    if bit_pm is None or bond_par is None:
        if chip or masks is None:
            raise ValueError("the tables may be left out only on the wide "
                             "tier (nq > 14), with their masks")
    else:
        _check(bit_pm, "bit_pm", (dim, nq), device)
        _check(bond_par, "bond_par", (dim, nb), device)
    re_out = torch.empty_like(re)
    im_out = torch.empty_like(im)
    stream = torch.cuda.current_stream(device).cuda_stream
    if chip:
        lib = load_library()
        with torch.cuda.device(device):
            err = lib.fused_trotter_step_launch(
                re.data_ptr(), im.data_ptr(), kick_signs.data_ptr(),
                bond_signs.data_ptr(), theta_j_col.data_ptr(),
                bit_pm.data_ptr(), bond_par.data_ptr(), re_out.data_ptr(),
                im_out.data_ptr(), rows, nq, nb, float(theta_h), stream)
    else:
        for name, t in (("re", re), ("im", im)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned (the "
                                 "kernel copies float4)")
        if masks is None:
            masks = step_masks(bit_pm, bond_par)
        elif (masks.device != device or masks.dtype != torch.int32
              or tuple(masks.shape) != (2 * dim + 1,)
              or not masks.is_contiguous()):
            raise ValueError(f"masks must be step_masks of the tables: "
                             f"contiguous int32 ({2 * dim + 1},) on {device}")
        lib = load_wide_library()
        with torch.cuda.device(device):
            err = lib.fused_trotter_step_wide_launch(
                re.data_ptr(), im.data_ptr(), kick_signs.data_ptr(),
                bond_signs.data_ptr(), theta_j_col.data_ptr(),
                masks.data_ptr(), re_out.data_ptr(), im_out.data_ptr(), rows,
                nq, nb, float(theta_h), stream)
    if err != 0:
        raise RuntimeError(f"fused_trotter_step kernel launch failed: CUDA "
                           f"error {err}")
    fused_trotter_step.launches += 1
    return re_out, im_out


# kernel launches since the last reset (set it to 0 to reset)
fused_trotter_step.launches = 0
