"""Kicked-Ising (TFIM Trotter) label generator: Pauli frames + WHT phases.

One Trotter step is ``RX(θh)⊗n · RZZ(θJ) on even bonds · RZZ(θJ) on odd
bonds``. Under the Pauli-twirled device noise model the only noisy gates
are the two CX that realize each RZZ. Every sampled noise Pauli is
commuted to the end of the circuit as a Pauli frame (exact: CX is
Clifford, and a rotation only flips its angle's sign where the frame
anticommutes with it). So a trajectory is the same circuit with ±1 angle
signs per rotation, plus a final X-flip mask folded into ⟨Z⟩. The state
evolution is then a Walsh–Hadamard transform around a per-trajectory RX
phase, and a per-trajectory ZZ phase: the fused kernel of
:mod:`.kernels.evolve`.

The stages of :meth:`KickedIsingEngine.run`:
(b) the frame pass: draw the noise Paulis (:meth:`~KickedIsingEngine.
sample_draws`) and propagate the frames (:meth:`~KickedIsingEngine.
frame_signs`), as int32 bit operations over all trajectories at once;
(c) the evolution (:meth:`~KickedIsingEngine.evolve`);
(d) readout confusion, ⟨Z⟩, the frame flip and binomial shots
(:meth:`~KickedIsingEngine.noisy_labels`).
Stage (a), the noise tables, is built once in the constructor.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from ..device.model import DeviceModel
from ..device.noise import NoiseModel
from . import sampling
from .density import apply_readout_confusion
from .kernels.evolve import evolve_fused, evolve_fused_reference, wht
from .trajectory import compose_pauli_channel, pauli_channel_probs

__all__ = ["EngineTables", "KickedIsingEngine", "wht"]


def _bonds(nq: int) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
    even = [(q, q + 1) for q in range(0, nq - 1, 2)]
    odd = [(q, q + 1) for q in range(1, nq - 1, 2)]
    return even, odd


def _sign_tables(nq: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host f32 ±1 tables: bit_pm [2^nq, nq] (bit q of amplitude j) and
    bond_par [2^nq, n_bonds] (its parity on each bond, even bonds first)."""
    even, odd = _bonds(nq)
    j = np.arange(2 ** nq)
    bit_pm = 2.0 * ((j[:, None] >> np.arange(nq)[None, :]) & 1
                    ).astype(np.float32) - 1.0
    bond_par = np.stack([bit_pm[:, a] * bit_pm[:, b] for a, b in even + odd],
                        axis=1)
    return bit_pm, bond_par


def _hadamard_dense(nq: int) -> np.ndarray:
    """Dense ±1/√2^n Hadamard [2^n, 2^n] float32 (host constant)."""
    h = np.array([[1.0]], dtype=np.float64)
    for _ in range(nq):
        h = np.block([[h, h], [h, -h]])
    return (h / np.sqrt(2.0 ** nq)).astype(np.float32)


@dataclasses.dataclass
class EngineTables:
    """The engine's noise tables, on the engine's device.

    bond_probs [n_bonds, 16] f32: twirled Pauli probabilities of each
    bond's CX (index 4·p_a + p_b); confusion [nq, 2, 2] f32 readout
    assignment matrices M[meas, true], or None without readout error.
    """

    bond_probs: torch.Tensor
    confusion: Optional[torch.Tensor]


@dataclasses.dataclass
class KickedIsingEngine:
    """Noisy + ideal per-qubit-Z label generator for the TFIM family.

    ``device`` is the torch device everything runs on. ``use_kernel``:
    None runs the CUDA kernel on a CUDA device and the plain PyTorch
    evolution on the CPU; True asks for the kernel (CUDA only); False runs
    the plain version anywhere.
    """

    device_model: DeviceModel
    nq: int
    steps: int
    device: Union[str, torch.device]
    dt: float = 0.25
    h: float = 1.0
    n_traj: int = 32
    shots: Optional[int] = 10000
    readout: bool = True
    noise_model: Optional[NoiseModel] = None
    use_kernel: Optional[bool] = None
    # ZNE noise amplification: each CX channel applied noise_scale times
    # (= local 2q folding at this noise factor). Composition of Pauli
    # channels is f^k in the Walsh domain — computed analytically.
    noise_scale: int = 1

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.nq > 30:
            raise ValueError("statevector width limit (use the sharded or "
                             "Pauli-propagation engines beyond ~30q)")
        if self.use_kernel and self.device.type != "cuda":
            raise ValueError("use_kernel=True needs a CUDA device, got "
                             f"{self.device}")
        self._use_kernel = (self.device.type == "cuda"
                            if self.use_kernel is None else self.use_kernel)
        nm = self.noise_model or NoiseModel.from_device(self.device_model)
        # of the gates this family uses (rx, rz, cx) only CX may carry noise
        touched = ({g for g, _ in nm.local_channels}
                   | set(nm.default_channels))
        conflict = touched & {"rx", "rz", "u3", "ry", "p"}
        if conflict:
            raise ValueError(
                f"KickedIsingEngine models CX+readout noise only; noise "
                f"model attaches channels to {sorted(conflict)} — use the "
                f"generic trajectory or density-matrix engines for those")
        even, odd = _bonds(self.nq)
        self.bonds = even + odd
        probs = []
        for (a, b) in self.bonds:
            chan = nm.channel_for("cx", (a, b))
            p = (pauli_channel_probs(chan) if chan is not None
                 else np.eye(1, 16, 0)[0])
            if self.noise_scale != 1:
                p = compose_pauli_channel(np.asarray(p, np.float64),
                                          int(self.noise_scale))
            probs.append(p.astype(np.float32))
        ro = (nm.readout[:self.nq]
              if self.readout and nm.readout is not None else None)
        self.tables = EngineTables(
            torch.as_tensor(np.stack(probs), device=self.device),
            None if ro is None else torch.as_tensor(
                np.asarray(ro, np.float32), device=self.device))
        bit_pm, bond_par = _sign_tables(self.nq)

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                   device=self.device)

        self._bit_pm_t = dev(bit_pm.T)
        self._bond_par_t = dev(bond_par.T)
        self._neg_bit_pm = dev(-bit_pm)     # ⟨Z_q⟩ = probs @ (−bit_pm)

    # ------------------------------------------------------------------
    # (b) frame pass
    # ------------------------------------------------------------------
    def sample_draws(self, rows: int, generator: torch.Generator
                     ) -> torch.Tensor:
        """Noise Paulis after every CX: int32 [steps, rows, n_bonds, 2]."""
        nb = len(self.bonds)
        return sampling.sample_small_categorical(
            self.tables.bond_probs[:, None, :], (self.steps, rows, nb, 2),
            generator)

    def frame_signs(self, draws: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Commute the drawn Paulis to the end of the circuit.

        draws [steps, rows, n_bonds, 2] (Pauli 4·p_a + p_b after each of a
        bond's two CX). Returns f32 ±1 kick signs [rows, steps·nq], bond
        signs [rows, steps·n_bonds] (the kernel's layout) and the final
        X-flip signs [rows, nq] that correct ⟨Z_q⟩. The frame is int32 X
        and Z bit masks over the qubits.
        """
        S, rows, nb, _ = draws.shape
        nq = self.nq
        pa, pb = draws // 4, draws % 4
        a_idx = torch.tensor([a for a, _ in self.bonds], dtype=torch.int32,
                             device=draws.device)[:, None]
        b_idx = torch.tensor([b for _, b in self.bonds], dtype=torch.int32,
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
        for s in range(S):
            # rx(θh) on every qubit flips iff the frame has Z/Y there
            kick[:, s] = 1 - 2 * ((z[:, None] >> qs) & 1)
            for k, (a, b) in enumerate(self.bonds):
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
        flip = (1 - 2 * ((x[:, None] >> qs) & 1)).float()
        return kick.reshape(rows, S * nq), bond.reshape(rows, S * nb), flip

    # ------------------------------------------------------------------
    # (c) evolution
    # ------------------------------------------------------------------
    def evolve(self, theta_h: float, theta_j_rows: torch.Tensor,
               kick: torch.Tensor, bond: torch.Tensor) -> torch.Tensor:
        """Evolve |0…0⟩ per row; returns probabilities [rows, 2^nq].

        The probabilities are computed in place in the evolved re plane.
        """
        rows = theta_j_rows.shape[0]
        re = torch.zeros((rows, 2 ** self.nq), dtype=torch.float32,
                         device=self.device)
        re[:, 0] = 1.0
        im = torch.zeros_like(re)
        fn = evolve_fused if self._use_kernel else evolve_fused_reference
        re, im = fn(re, im, kick, bond,
                    theta_j_rows.reshape(rows, 1).contiguous(),
                    self._bit_pm_t, self._bond_par_t, theta_h, self.steps,
                    self.nq, len(self.bonds))
        return re.mul_(re).addcmul_(im, im)

    # ------------------------------------------------------------------
    # (d) readout, ⟨Z⟩, frame flip, shots
    # ------------------------------------------------------------------
    def noisy_labels(self, probs: torch.Tensor, flip: torch.Tensor,
                     generator: torch.Generator) -> torch.Tensor:
        """Noisy ⟨Z_q⟩ [B, nq] from the trajectories' probabilities."""
        if self.tables.confusion is not None:
            probs = apply_readout_confusion(probs, self.tables.confusion,
                                            self.nq)
        z = (probs @ self._neg_bit_pm) * flip
        z = z.reshape(-1, self.n_traj, self.nq)
        if self.shots is None:
            return z.mean(dim=1)
        shots_per_traj = max(1, self.shots // self.n_traj)
        p1 = ((1.0 - z) / 2.0).clamp(0.0, 1.0)
        counts = torch.binomial(torch.full_like(p1, float(shots_per_traj)),
                                p1, generator=generator)
        return (1.0 - 2.0 * counts / shots_per_traj).mean(dim=1)

    # ------------------------------------------------------------------
    def run(self, J: torch.Tensor, generator: torch.Generator,
            mark: Optional[Callable[[str], None]] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ideal, noisy) ⟨Z_q⟩ [B, nq] for couplings J [B] on the device.

        ``mark``, if given, is called with a stage's name as each stage
        has been enqueued ("frame", "evolve", "readout", "ideal"), so a
        caller can time the stages.
        """
        mark = mark or (lambda stage: None)
        B, S, nq, nb = J.shape[0], self.steps, self.nq, len(self.bonds)
        theta_h = 2.0 * self.h * self.dt
        theta_j = (-2.0 * self.dt) * J.to(torch.float32)
        draws = self.sample_draws(B * self.n_traj, generator)
        kick, bond, flip = self.frame_signs(draws)
        del draws
        mark("frame")
        probs = self.evolve(theta_h, theta_j.repeat_interleave(self.n_traj),
                            kick, bond)
        del kick, bond
        mark("evolve")
        noisy = self.noisy_labels(probs, flip, generator)
        del probs
        mark("readout")
        # ideal labels: the same evolution with every sign +1, one row per
        # circuit
        ones_k = torch.ones((B, S * nq), device=self.device)
        ones_b = torch.ones((B, S * nb), device=self.device)
        ideal = self.evolve(theta_h, theta_j, ones_k, ones_b
                            ) @ self._neg_bit_pm
        mark("ideal")
        return ideal, noisy

    def generate(self, J_values: np.ndarray, seed: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """(ideal, noisy) per-qubit ⟨Z⟩ as numpy [B, nq]; noise from seed."""
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        J = torch.as_tensor(np.asarray(J_values, np.float32),
                            device=self.device)
        ideal, noisy = self.run(J, generator)
        return ideal.cpu().numpy(), noisy.cpu().numpy()
