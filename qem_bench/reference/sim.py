"""Gate-by-gate statevector simulation of the kicked-Ising Trotter circuit.

A step is RX(θ_h) on every qubit, then each bond (even bonds first) as
CX → Pauli error → RZ(θ_J) on the target → CX → Pauli error, with
θ_h = 2·h·dt and θ_J = −2·J·dt. Qubit q is bit q of the amplitude index.
The state is held as real planes [rows, 2^w, 2] (re, im). A one-qubit
rotation is a real 4×4 matrix applied with ``torch.matmul``, so a run in
float32 with TF32 matmuls allowed computes in TF32 (the control of the
correctness check); the reference runs in float64.

Errors are drawn from the reference's own generator, one two-qubit Pauli
after each CX of each row (``fold`` of them, multiplied, under noise
amplification by local folding), and applied to the state as gates.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .noise import X_BIT, Z_BIT


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 mantissa bits (to nearest)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class Chain:
    """A batch of ``rows`` states of ``w`` qubits, all |0…0⟩. ``tf32``
    rounds both operands of each rotation's matmul to TF32 (float32
    states only), as the tensor cores do with TF32 allowed."""

    def __init__(self, rows: int, w: int, dtype: torch.dtype,
                 device: torch.device, tf32: bool = False):
        self.w, self.rows, self.tf32 = w, rows, tf32
        self.psi = torch.zeros((rows, 2 ** w, 2), dtype=dtype, device=device)
        self.psi[:, 0, 0] = 1.0

    def _view(self, q: int) -> torch.Tensor:
        """[rows, hi, 2 (bit q), lo, 2 (re, im)]."""
        return self.psi.view(self.rows, 2 ** (self.w - 1 - q), 2, 2 ** q, 2)

    def rx(self, q: int, theta: float) -> None:
        c, s = math.cos(theta / 2), math.sin(theta / 2)
        # (x0, y0, x1, y1) → RX·(x0 + i y0, x1 + i y1)
        m = torch.tensor([[c, 0, 0, s], [0, c, -s, 0], [0, s, c, 0],
                          [-s, 0, 0, c]], dtype=self.psi.dtype,
                         device=self.psi.device)
        v = self._view(q).permute(0, 1, 3, 2, 4)       # [rows, hi, lo, 2, 2]
        shape = v.shape
        v, m = v.reshape(-1, 4), m.T
        if self.tf32:
            v, m = round_tf32(v), round_tf32(m)
        out = torch.matmul(v, m).reshape(shape)
        self.psi = out.permute(0, 1, 3, 2, 4).reshape(self.psi.shape)

    def cx(self, a: int, b: int) -> None:
        j = torch.arange(2 ** self.w, device=self.psi.device)
        src = j ^ (((j >> a) & 1) << b)
        self.psi = self.psi.index_select(1, src)

    def rz(self, q: int, theta: torch.Tensor) -> None:
        """RZ with a per-row angle ``theta`` [rows]."""
        v = self._view(q)
        half = (theta.to(self.psi.dtype) / 2).reshape(-1, 1, 1)
        for bit, sign in ((0, -1.0), (1, 1.0)):
            c, s = torch.cos(sign * half), torch.sin(sign * half)
            x, y = v[:, :, bit, :, 0].clone(), v[:, :, bit, :, 1].clone()
            v[:, :, bit, :, 0] = x * c - y * s
            v[:, :, bit, :, 1] = x * s + y * c

    def pauli(self, q: int, code: torch.Tensor) -> None:
        """The one-qubit Pauli ``code`` [rows] (0..3 = I, X, Y, Z) on each
        row, up to a global phase per row."""
        x = torch.as_tensor(X_BIT, device=code.device)[code].bool()
        z = torch.as_tensor(Z_BIT, device=code.device)[code].bool()
        v = self._view(q)
        neg = torch.where(z, -1.0, 1.0).to(v.dtype).reshape(-1, 1, 1, 1)
        v[:, :, 1] *= neg
        flipped = v.flip(2)
        self.psi = torch.where(x.reshape(-1, 1, 1, 1, 1), flipped,
                               v).reshape(self.psi.shape)

    def z(self, q: int) -> torch.Tensor:
        """⟨Z_q⟩ of each row, in the state's precision."""
        p = (self._view(q) ** 2).sum(dim=-1)            # [rows, hi, 2, lo]
        return (p[:, :, 0] - p[:, :, 1]).sum(dim=(1, 2))


def draw_paulis(probs: np.ndarray, n: int, fold: int,
                generator: torch.Generator, device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` two-qubit Paulis from ``probs`` [16], each the product of
    ``fold`` independent draws: (control code, target code), int64 [n]."""
    cdf = torch.as_tensor(np.cumsum(probs), dtype=torch.float64,
                          device=device)
    x = torch.zeros((2, n), dtype=torch.int64, device=device)
    z = torch.zeros_like(x)
    xb = torch.as_tensor(X_BIT, device=device)
    zb = torch.as_tensor(Z_BIT, device=device)
    for _ in range(fold):
        u = torch.rand(n, dtype=torch.float64, generator=generator,
                       device=device) * cdf[-1]
        idx = torch.searchsorted(cdf, u, right=True).clamp_(max=15)
        for k, code in enumerate((idx // 4, idx % 4)):
            x[k] ^= xb[code]
            z[k] ^= zb[code]
    # (x, z) bits back to codes: I 00, X 10, Y 11, Z 01
    codes = torch.tensor([[0, 3], [1, 2]], device=device)[x, z]
    return codes[0], codes[1]


def trotter_z(w: int, bonds: Sequence[Tuple[int, int]], theta_j: torch.Tensor,
              theta_h: float, steps: int, obs: Sequence[int],
              bond_probs: Optional[Sequence[np.ndarray]] = None,
              fold: int = 1, generator: Optional[torch.Generator] = None,
              dtype: torch.dtype = torch.float64, tf32: bool = False
              ) -> torch.Tensor:
    """⟨Z_q⟩ for q in ``obs`` after each step: [steps, rows, len(obs)].

    ``theta_j`` [rows] is each row's θ_J. With ``bond_probs`` (one [16]
    array a bond, in ``bonds``' order) every row draws its own Pauli errors
    from ``generator``; without, the circuit is noise-free.
    """
    rows = theta_j.shape[0]
    st = Chain(rows, w, dtype, theta_j.device, tf32)
    out = torch.empty((steps, rows, len(obs)), dtype=dtype,
                      device=theta_j.device)
    for s in range(steps):
        for q in range(w):
            st.rx(q, theta_h)
        for k, (a, b) in enumerate(bonds):
            for half in (0, 1):
                st.cx(a, b)
                if bond_probs is not None:
                    ca, cb = draw_paulis(bond_probs[k], rows, fold,
                                         generator, theta_j.device)
                    st.pauli(a, ca)
                    st.pauli(b, cb)
                if half == 0:
                    st.rz(b, theta_j)
        for i, q in enumerate(obs):
            out[s, :, i] = st.z(q)
    return out


def blocks(n: int, size: int) -> List[slice]:
    return [slice(i, min(i + size, n)) for i in range(0, n, size)]
