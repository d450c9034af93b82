"""Sparse Pauli propagation: 100Q+ noisy TFIM expectation values.

Counterpart of ``mlqem_tpu/ops/pauli_prop.py``. Heisenberg-picture
simulation (the Begušić–Chan approach): the observable is expanded in the
Pauli basis and conjugated backward through the circuit.

* Clifford gates (CX) remap each Pauli term exactly (16-entry lookup).
* Rotations (RX kick, the RZ inside each bond) split anticommuting terms
  in two (cos/sin branches); growth is held to the top K terms by
  |coefficient| after every split (the discarded weight is tracked).
* Twirled Pauli noise is diagonal here: each term is scaled by
  f = Σ_p prob_p·(±1).
* ⟨0…0|P|0…0⟩ = 1 for X-free terms, else 0.

Terms are bit words (``int32[..., K, W]``, W = ⌈n/32⌉; bit 31 of a word
reads back through the arithmetic shift as ``(w >> 31) & 1``) and float32
coefficients. Every op takes leading row dimensions, so the engine runs
all (J, observable qubit) rows of a call at once as ``[R, K, W]``.

Top-K keeps the first K of a stable descending sort of |c| over the
candidates: the lower index wins a tie, as ``jax.lax.top_k`` does (ties
are common here: the engine never merges duplicate strings, and the
Clifford kick θ_h = π/2 splits every term into a pair of equal
magnitude). The engine holds only the live prefix of its K slots: after a
split it trims to the largest count of non-zero coefficients of any row.
Zero-coefficient slots sort last in the fixed-K form too, so the kept
terms and their order are the same as with all K slots carried.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device.model import DeviceModel
from ..device.noise import NoiseModel

Device = Union[str, torch.device]

# ---------------------------------------------------------------------------
# host-side lookup tables (local 2q Pauli algebra)
# local code per qubit: 0=I, 1=X, 2=Y, 3=Z  (x-bit = code∈{1,2},
# z-bit = code∈{2,3}); 2q code = 4·code_a + code_b
# ---------------------------------------------------------------------------
_P1 = [np.eye(2), np.array([[0, 1], [1, 0]]),
       np.array([[0, -1j], [1j, 0]]), np.diag([1, -1])]


def _code_mat(c2: int) -> np.ndarray:
    """The 4x4 matrix of 2q Pauli code c2 (a = MSB)."""
    a, b = divmod(c2, 4)
    return np.kron(_P1[a], _P1[b])


def _find_code_sign(m: np.ndarray) -> Tuple[int, complex]:
    """(code, phase) with m = phase · _code_mat(code); raises if m is not
    a Pauli up to a phase in {±1, ±i}."""
    for c in range(16):
        ref = _code_mat(c)
        for sign in (1, -1, 1j, -1j):
            if np.allclose(m, sign * ref, atol=1e-9):
                return c, sign
    raise ValueError("not a Pauli")


def _cx_conj_table() -> Tuple[np.ndarray, np.ndarray]:
    """CX·P·CX for the 16 local codes → (new_code[16], sign[16])."""
    cx = np.eye(4)[[0, 1, 3, 2]]
    codes = np.zeros(16, np.int32)
    signs = np.zeros(16, np.float32)
    for c in range(16):
        nc, s = _find_code_sign(cx @ _code_mat(c) @ cx)
        assert s in (1, -1)
        codes[c], signs[c] = nc, np.real(s)
    return codes, signs


def _zz_mult_table() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """For A = Z⊗Z: (anti[16], new_code[16], sign[16]) with
    i·A·P = sign·(new code), valid where anti."""
    A = _code_mat(4 * 3 + 3)
    anti = np.zeros(16, bool)
    new_code = np.zeros(16, np.int32)
    sign = np.zeros(16, np.float32)
    for c in range(16):
        P = _code_mat(c)
        if np.allclose(A @ P, P @ A):
            continue
        anti[c] = True
        nc, s = _find_code_sign(1j * A @ P)
        assert s in (1, -1), s
        new_code[c], sign[c] = nc, np.real(s)
    return anti, new_code, sign


def _axis_mult_table(A) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """For a 1q axis A: anticommute[4], i·A·P = sign·new code."""
    anti = np.zeros(4, bool)
    new_code = np.zeros(4, np.int32)
    sign = np.zeros(4, np.float32)
    for c in range(4):
        P = _P1[c]
        if np.allclose(A @ P, P @ A):
            continue
        anti[c] = True
        m = 1j * A @ P
        for cc in range(4):
            for s in (1, -1, 1j, -1j):
                if np.allclose(m, s * _P1[cc], atol=1e-9):
                    new_code[c], sign[c] = cc, np.real(s)
    return anti, new_code, sign


_CX_CODES, _CX_SIGNS = _cx_conj_table()
_ZZ_ANTI, _ZZ_NEW, _ZZ_SIGN = _zz_mult_table()
_X_ANTI, _X_NEW, _X_SIGN = _axis_mult_table(_P1[1])
_Z_ANTI, _Z_NEW, _Z_SIGN = _axis_mult_table(_P1[3])


def _table(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    dtype = {np.dtype(bool): torch.bool, np.dtype(np.int32): torch.int64,
             np.dtype(np.float32): torch.float32}[a.dtype]
    return torch.as_tensor(a, dtype=dtype, device=like.device)


# ---------------------------------------------------------------------------
# term-set primitives
# ---------------------------------------------------------------------------
def _bit_mask(q: int) -> int:
    """The int32 word mask of qubit q's bit, as a Python int."""
    s = q % 32
    return -(1 << 31) if s == 31 else 1 << s


def _get_bit(words: torch.Tensor, q: int) -> torch.Tensor:
    return (words[..., q // 32] >> (q % 32)) & 1


def _set_bit_val(words: torch.Tensor, q: int, val: torch.Tensor
                 ) -> torch.Tensor:
    mask = _bit_mask(q)
    cur = words[..., q // 32]
    out = words.clone()
    out[..., q // 32] = torch.where(val.bool(), cur | mask, cur & ~mask)
    return out


def local_code(x: torch.Tensor, z: torch.Tensor, q: int) -> torch.Tensor:
    """The local Pauli code (0=I, 1=X, 2=Y, 3=Z) of every term at q."""
    xb, zb = _get_bit(x, q), _get_bit(z, q)
    # (x,z): (0,0)→I=0, (1,0)→X=1, (1,1)→Y=2, (0,1)→Z=3
    return (xb * (1 + zb) + (1 - xb) * 3 * zb).long()


def _write_code(x: torch.Tensor, z: torch.Tensor, q: int,
                code: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xb = (code == 1) | (code == 2)
    zb = (code == 2) | (code == 3)
    return _set_bit_val(x, q, xb), _set_bit_val(z, q, zb)


@dataclasses.dataclass
class TermSet:
    """Fixed-capacity sparse Pauli sums: bit words + coefficients."""

    x: torch.Tensor       # int32[..., K, W]
    z: torch.Tensor       # int32[..., K, W]
    coeff: torch.Tensor   # float32[..., K] (0 = empty slot)


def _code2(ts: TermSet, a: int, b: int) -> torch.Tensor:
    return 4 * local_code(ts.x, ts.z, a) + local_code(ts.x, ts.z, b)


def conj_cx(ts: TermSet, a: int, b: int) -> TermSet:
    code = _code2(ts, a, b)
    new_code = _table(_CX_CODES, code)[code]
    sign = _table(_CX_SIGNS, code)[code]
    x, z = _write_code(ts.x, ts.z, a, new_code // 4)
    x, z = _write_code(x, z, b, new_code % 4)
    return TermSet(x, z, ts.coeff * sign)


def damp_pauli_channel(ts: TermSet, a: int, b: int,
                       f_local: torch.Tensor) -> TermSet:
    """Scale each term by the channel's damping factor f_local[16]
    (indexed by the term's local code at (a, b))."""
    return TermSet(ts.x, ts.z, ts.coeff * f_local[_code2(ts, a, b)])


def _trig(theta, like: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 (cos θ, sin θ), rounded from float64 on the host, so the
    card and the CPU take the same values; shaped to broadcast over the
    last (term) axis of ``like``'s coefficients."""
    th = np.asarray(theta, np.float64)
    c, s = (torch.as_tensor(f(th).astype(np.float32), device=like.device)
            for f in (np.cos, np.sin))
    if th.ndim:
        c, s = c[..., None], s[..., None]
    return c, s


def _split(ts: TermSet, anti: torch.Tensor, new_sign: torch.Tensor,
           cos_t: torch.Tensor, sin_t: torch.Tensor,
           write_codes: Tuple[torch.Tensor, torch.Tensor], K: int
           ) -> Tuple[TermSet, torch.Tensor]:
    """Generic rotation split + top-K compaction.

    anti[..., K] bool; surviving branch coeff·cosθ (where anti) else coeff;
    new branch coeff·sinθ·sign with codes written; keep the first K of a
    stable descending sort of |coeff| over the candidates (the lower index
    wins a tie). Returns (new TermSet, discarded weight [...]).
    """
    keep_coeff = torch.where(anti, ts.coeff * cos_t, ts.coeff)
    new_coeff = torch.where(anti, ts.coeff * sin_t * new_sign,
                            torch.zeros((), dtype=ts.coeff.dtype,
                                        device=ts.coeff.device))
    x2, z2 = write_codes
    c_all = torch.cat([keep_coeff, new_coeff], dim=-1)
    mag, idx = torch.sort(c_all.abs(), dim=-1, descending=True, stable=True)
    k = min(K, c_all.shape[-1])
    idx = idx[..., :k]
    disc = mag[..., k:].sum(-1)
    widx = idx[..., None].expand(*idx.shape, ts.x.shape[-1])
    x = torch.cat([ts.x, x2], dim=-2).gather(-2, widx)
    z = torch.cat([ts.z, z2], dim=-2).gather(-2, widx)
    return TermSet(x, z, c_all.gather(-1, idx)), disc


def _rot_zz(ts, a, b, cos_t, sin_t, K):
    code = _code2(ts, a, b)
    nc = _table(_ZZ_NEW, code)[code]
    x2, z2 = _write_code(ts.x, ts.z, a, nc // 4)
    x2, z2 = _write_code(x2, z2, b, nc % 4)
    return _split(ts, _table(_ZZ_ANTI, code)[code],
                  _table(_ZZ_SIGN, code)[code], cos_t, sin_t, (x2, z2), K)


def _rot_axis(ts, q, tables, cos_t, sin_t, K):
    anti_t, new_t, sign_t = tables
    code = local_code(ts.x, ts.z, q)
    x2, z2 = _write_code(ts.x, ts.z, q, _table(new_t, code)[code])
    return _split(ts, _table(anti_t, code)[code], _table(sign_t, code)[code],
                  cos_t, sin_t, (x2, z2), K)


_X_TABLES = (_X_ANTI, _X_NEW, _X_SIGN)
_Z_TABLES = (_Z_ANTI, _Z_NEW, _Z_SIGN)


def rot_zz(ts: TermSet, a: int, b: int, theta, K: int):
    """Conjugate through RZZ(θ) on (a,b): split anticommuting terms.
    ``theta`` is a host number, or one per leading row."""
    return _rot_zz(ts, a, b, *_trig(theta, ts.coeff), K)


def rot_x(ts: TermSet, q: int, theta, K: int):
    """Conjugate through RX(θ) on q."""
    return _rot_axis(ts, q, _X_TABLES, *_trig(theta, ts.coeff), K)


def rot_z(ts: TermSet, q: int, theta, K: int):
    """Conjugate through RZ(θ) on q."""
    return _rot_axis(ts, q, _Z_TABLES, *_trig(theta, ts.coeff), K)


def expectation_zero_state(ts: TermSet) -> torch.Tensor:
    """⟨0…0|Σ c_i P_i|0…0⟩ = Σ of coefficients of X-free terms."""
    x_free = (ts.x == 0).all(dim=-1)
    return torch.where(x_free, ts.coeff, torch.zeros_like(ts.coeff)).sum(-1)


def _trim(ts: TermSet) -> TermSet:
    """Keep the live prefix: after a split the non-zero coefficients of
    every row come first, so slots past the largest count of any row hold
    zeros only (at least one slot stays)."""
    live = max(1, int((ts.coeff != 0).sum(-1).max()))
    if live == ts.coeff.shape[-1]:
        return ts
    return TermSet(ts.x[..., :live, :], ts.z[..., :live, :],
                   ts.coeff[..., :live])


# ---------------------------------------------------------------------------
# the kicked-Ising Heisenberg engine
# ---------------------------------------------------------------------------
# rows of one propagation call: candidates (2K terms) × (two word arrays of
# W int32, the coefficient, |c|, its sort index and the gathers) come to
# ~(16·W + 40) bytes a candidate slot; rows are chunked to stay under this
_CALL_BYTES = 4 << 30


class PauliPropagatorIsing:
    """Noisy ⟨Z_q⟩ for the TFIM Trotter family at 100Q+ via Pauli
    propagation with twirled device noise.

    Noise (optional) damps terms at each physical CX site; ``noise_scale``
    amplifies every damping exponent (the ZNE noise-factor knob: local
    2q folding at factor nf applies each CX channel nf times → f^nf).
    ``device_model`` is the calibration; ``device`` the torch device the
    propagation runs on.
    """

    def __init__(self, device_model: DeviceModel, nq: int, steps: int,
                 dt: float = 0.25, h: float = 1.0,
                 max_terms: int = 4096,
                 noise_model: Optional[NoiseModel] = None,
                 noise: bool = True,
                 readout: bool = True,
                 device: Device = "cuda"):
        self.nq, self.steps, self.dt, self.h = nq, steps, dt, h
        self.K = max_terms
        self.W = (nq + 31) // 32
        self.device_model = device_model
        self.device = torch.device(device)
        nm = (noise_model or NoiseModel.from_device(device_model)) if noise \
            else None
        self._nm = nm
        from .trajectory import pauli_channel_probs

        # commutation-sign table: w[P_code, Q_code] for damping factors
        w = np.zeros((16, 16), np.float32)
        for pc in range(16):
            Pm = _code_mat(pc)
            for qc in range(16):
                Qm = _code_mat(qc)
                w[pc, qc] = 1.0 if np.allclose(Pm @ Qm, Qm @ Pm) else -1.0
        even = [(q, q + 1) for q in range(0, nq - 1, 2)]
        odd = [(q, q + 1) for q in range(1, nq - 1, 2)]
        self.bonds = even + odd
        self._f_local: Dict[Tuple[int, int], np.ndarray] = {}
        for (a, b) in self.bonds:
            chan = None if nm is None else nm.channel_for("cx", (a, b))
            if chan is None:
                self._f_local[(a, b)] = np.ones(16, np.float32)
            else:
                probs = pauli_channel_probs(chan).astype(np.float32)
                self._f_local[(a, b)] = w @ probs   # f_P = Σ_q p_q·w(P,q)
        self._readout = None
        if readout and nm is not None and nm.readout is not None:
            self._readout = nm.readout[:nq]

    def _damping(self, noise_scale) -> Optional[np.ndarray]:
        """[n_bonds, 16] damping in backward bond order, raised to the
        noise factor with its sign (Pauli fidelities can be negative, so
        (-f)^k keeps exact odd/even semantics); None when every factor
        is 1 (the ideal arm: multiplying by 1 changes nothing)."""
        noise_scale = int(round(noise_scale))
        f_rev = np.stack([self._f_local[b] for b in self.bonds[::-1]])
        f_pow = np.sign(f_rev) ** noise_scale * \
            np.abs(f_rev) ** noise_scale if noise_scale != 1 else f_rev
        f_pow = f_pow.astype(np.float32)
        return None if bool((f_pow == 1.0).all()) else f_pow

    def _propagate(self, rows_q: np.ndarray, theta_rows: np.ndarray,
                   theta_h: np.float32, f_rev: Optional[np.ndarray]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Rows (observable qubit, θ_J): per-step values and cumulative
        discarded weight, [steps, R] each, on the device."""
        dev, R, W = self.device, len(rows_q), self.W
        z = np.zeros((R, 1, W), np.int32)
        z[np.arange(R), 0, rows_q // 32] = [_bit_mask(int(q)) for q in rows_q]
        ts = TermSet(torch.zeros((R, 1, W), dtype=torch.int32, device=dev),
                     torch.as_tensor(z, device=dev),
                     torch.ones((R, 1), dtype=torch.float32, device=dev))
        like = ts.coeff
        cj, sj = _trig(theta_rows, like)
        ch, sh = _trig(theta_h, like)
        f_dev = None if f_rev is None else torch.as_tensor(f_rev, device=dev)
        disc = torch.zeros(R, dtype=torch.float32, device=dev)
        vals, discs = [], []
        bonds_rev = self.bonds[::-1]
        for _ in range(self.steps):
            for i, (a, b) in enumerate(bonds_rev):
                # forward: cx1 → noise1 → rz(θ_j, b) → cx2 → noise2; the
                # backward order is the exact reverse: noise1 damps the
                # observable as conjugated to its own site, BEFORE cx1
                if f_dev is not None:
                    ts = damp_pauli_channel(ts, a, b, f_dev[i])   # noise2
                ts = conj_cx(ts, a, b)                            # cx2
                ts, d = _rot_axis(ts, b, _Z_TABLES, cj, sj, self.K)   # rz
                disc = disc + d
                ts = _trim(ts)
                if f_dev is not None:
                    ts = damp_pauli_channel(ts, a, b, f_dev[i])   # noise1
                ts = conj_cx(ts, a, b)                            # cx1
            for q in range(self.nq - 1, -1, -1):
                ts, d = _rot_axis(ts, q, _X_TABLES, ch, sh, self.K)
                disc = disc + d
                ts = _trim(ts)
            vals.append(expectation_zero_state(ts))
            discs.append(disc)
        return torch.stack(vals), torch.stack(discs)

    def _run_stepwise(self, J_values, noise_scale, qubits
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-step values/discards: ([B, steps, nq'], [B, steps, nq']).

        One propagation carries every (J, observable qubit) row of the
        call, chunked by rows so one call's candidate arrays stay under
        ``_CALL_BYTES``."""
        f_rev = self._damping(noise_scale)
        theta_np = -2.0 * self.dt * np.asarray(J_values, np.float32)
        theta_h = np.float32(2.0 * self.h * self.dt)
        q_np = np.asarray(qubits, np.int32)
        B, Q = len(theta_np), len(q_np)
        rows_q = np.tile(q_np, B)                  # row = b·Q + qubit index
        rows_th = np.repeat(theta_np, Q)
        per_row = 2 * self.K * (16 * self.W + 40)
        chunk = max(1, _CALL_BYTES // per_row)
        vals = np.empty((self.steps, B * Q), np.float32)
        errs = np.empty((self.steps, B * Q), np.float32)
        for r0 in range(0, B * Q, chunk):
            v, e = self._propagate(rows_q[r0:r0 + chunk],
                                   rows_th[r0:r0 + chunk], theta_h, f_rev)
            vals[:, r0:r0 + chunk] = v.cpu().numpy()
            errs[:, r0:r0 + chunk] = e.cpu().numpy()
        vals = vals.reshape(self.steps, B, Q).transpose(1, 0, 2)
        errs = errs.reshape(self.steps, B, Q).transpose(1, 0, 2)
        if self._readout is not None:
            p = np.array([self._readout[q][1, 0] + self._readout[q][0, 1]
                          for q in qubits], np.float32) / 2.0
            vals = vals * (1.0 - 2.0 * p)[None, None, :]
        return np.ascontiguousarray(vals), np.ascontiguousarray(errs)

    def generate(self, J_values: np.ndarray, noise_scale: float = 1.0,
                 qubits: Optional[Sequence[int]] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """(values[B, len(qubits)], discarded_weight[B, len(qubits)]).

        Noisy per-qubit ⟨Z_q⟩ after all Trotter steps (readout applied
        analytically: z → (1-2p_q)·z for symmetric assignment error).
        """
        qubits = list(qubits) if qubits is not None else list(range(self.nq))
        vals, errs = self._run_stepwise(J_values, noise_scale, qubits)
        return vals[:, -1, :], errs[:, -1, :]

    def generate_stepwise(self, J_values: np.ndarray,
                          noise_scale: float = 1.0,
                          qubits: Optional[Sequence[int]] = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-Trotter-step values from one propagation.

        Returns (values[B, steps, nq'], cumulative_discard[B, steps, nq'])
        — step s (0-indexed) is the state after s+1 Trotter steps, so one
        propagation serves a whole depth sweep and the truncation audit
        reads the per-step drift directly.
        """
        qubits = list(qubits) if qubits is not None else list(range(self.nq))
        return self._run_stepwise(J_values, noise_scale, qubits)
