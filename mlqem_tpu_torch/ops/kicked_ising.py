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
:mod:`.kernels.evolve` (K1) up to its width of 13 qubits, and above it
:func:`kicked_steps`, one step at a time through K3
(:mod:`.kernels.fused_step`: its chip tier at 14 qubits, its wide tier in
passes over device memory from 15); the light-cone engine evolves its
windows through the same :func:`kicked_steps`.

The stages of :meth:`KickedIsingEngine.run`:
(b) the frame pass: draw the noise Paulis (:meth:`~KickedIsingEngine.
sample_draws`) and propagate the frames (:meth:`~KickedIsingEngine.
frame_signs`), as int32 bit operations over all trajectories at once;
(c) the evolution (:meth:`~KickedIsingEngine.evolve`);
(d) ⟨Z⟩, readout confusion and the frame flip (:meth:`~KickedIsingEngine.
trajectory_z`), then binomial shots (:meth:`~KickedIsingEngine.
shot_labels`). The assignment matrices act on one qubit each, so the
confusion is applied to each qubit's ⟨Z⟩ and the row's total, never to
the [rows, 2^nq] distribution.
Stage (a), the noise tables, is built once in the constructor.

Spans (:func:`~..utils.profiling.span`, recorded only while a profiler
runs or under :func:`~..utils.profiling.tracing`): ``kicked.engine`` (the
constructor, the twirl of each bond's channel inside it as
``trajectory.twirl``), ``kicked.generate`` (a request), and in
:meth:`~KickedIsingEngine.run` ``kicked.frame`` (b), ``kicked.evolve``
(c), ``kicked.readout`` (d, with its ``kicked.confusion``) and
``kicked.ideal``; :func:`kicked_steps` records each step's K3 call as
``kicked.step``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device.model import DeviceModel
from ..device.noise import NoiseModel
from ..parallel.mesh import gather_rows, shard_rows
from ..utils.profiling import span
from . import sampling
from .density import readout_affine
from .kernels import evolve as k_evolve
from .kernels import fused_step as k_step
from .kernels.wht import check_ieee_matmul, hadamard_dense, wht
from .trajectory import compose_pauli_channel, pauli_channel_probs

__all__ = ["EngineTables", "KickedIsingEngine", "kicked_steps",
           "propagate_frames", "wht", "wht_mm"]

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
    bond_par = np.empty((2 ** nq, len(even + odd)), np.float32)
    for k, (a, b) in enumerate(even + odd):
        bond_par[:, k] = bit_pm[:, a] * bit_pm[:, b]
    return bit_pm, bond_par


def wht_mm(state: torch.Tensor, nq: int, radix: int = 7) -> torch.Tensor:
    """H⊗nq over the last axis as dense Hadamard matmuls, at IEEE f32.

    Equal to :func:`wht`, but H⊗nq is factored into ⌈nq/radix⌉ Kronecker
    slabs of ≤ 2^radix, each contracted with a dense ±1/√d Hadamard: the
    JAX light-cone engine's WHT at windows of 12 qubits and more. Complex
    states take two real matmuls per slab (H is real).
    """
    parts: List[int] = []
    rem = nq
    while rem > 0:
        c = min(radix, rem)
        parts.append(c)
        rem -= c
    if len(parts) > 8:   # the JAX version's einsum letters cover ≤ 8 slabs
        raise ValueError(f"wht_mm supports nq <= {8 * radix} at "
                         f"radix={radix} (got nq={nq}); raise radix or "
                         "use the butterfly wht()")
    check_ieee_matmul(state)
    batch = state.shape[:-1]
    dims = tuple(2 ** c for c in parts)

    def real_pass(x):
        x = x.reshape(batch + dims)
        for i, c in enumerate(parts):
            h = torch.as_tensor(hadamard_dense(c), device=x.device)
            axis = len(batch) + i
            x = (x.movedim(axis, -1) @ h).movedim(-1, axis)
        return x.reshape(batch + (2 ** nq,))

    if state.is_complex():
        return torch.complex(real_pass(state.real), real_pass(state.imag))
    return real_pass(state)


def propagate_frames(draws: torch.Tensor, bonds: Sequence[Tuple[int, int]],
                     nq: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Commute the drawn noise Paulis to the end of the circuit.

    draws [steps, rows, n_bonds, 2]: the Pauli 4·p_a + p_b after each of a
    bond's two CX, bonds in application order. Returns f32 ±1 kick signs
    [rows, steps, nq] (each step's RX flips where the frame has Z/Y), bond
    signs [rows, steps, n_bonds] (a bond's RZ flips where the frame has X/Y
    on its target) and the frame's int32 X mask after each step
    [steps, rows]. The frame is int32 X and Z bit masks over the qubits.
    """
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


def basis_planes(rows: int, nq: int, device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """re/im planes [rows, 2^nq] of |0…0⟩."""
    re = torch.zeros((rows, 2 ** nq), dtype=torch.float32, device=device)
    re[:, 0] = 1.0
    return re, torch.zeros_like(re)


def kicked_steps(re: torch.Tensor, im: torch.Tensor,
                 kick: Optional[torch.Tensor], bond: Optional[torch.Tensor],
                 theta_j_rows: torch.Tensor, bit_pm: torch.Tensor,
                 bond_par: torch.Tensor, theta_h: float, steps: int,
                 use_kernel: bool = True,
                 after_step: Optional[Callable[[int, torch.Tensor,
                                                torch.Tensor], None]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evolve re/im [rows, 2^w] through ``steps`` kicked-Ising Trotter
    steps, one step at a time; returns the evolved (re, im).

    ``kick`` [rows, steps, w] and ``bond`` [rows, steps, nb] are the ±1
    angle signs, or None for all +1 (an ideal arm). The tables are in the
    JAX layout: bit_pm [2^w, w], bond_par [2^w, nb]. A step is
    :func:`~.kernels.fused_step.fused_trotter_step` (K3) at every width;
    above its chip tier the masks of the tables are built once a call
    (:func:`~.kernels.fused_step.step_masks`). ``use_kernel=False`` takes
    the plain version; otherwise the wrapper picks kernel or plain version
    by the tensors' device (a width no kernel takes raises on a CUDA
    tensor). Each step returns new planes and drops the last ones, so
    planes that the caller does not hold on to (``kicked_steps(
    *basis_planes(...), ...)``) keep two states alive, not three.
    ``after_step(s, re, im)`` is called after each step. Each step's
    call is the span ``kicked.step``.
    """
    w, nb = bit_pm.shape[1], bond_par.shape[1]
    rows = theta_j_rows.shape[0]
    after_step = after_step or (lambda s, re_, im_: None)
    if not use_kernel:
        step = k_step.fused_trotter_step_reference
    elif w > k_step.MAX_CHIP_NQ:
        step = functools.partial(k_step.fused_trotter_step,
                                 masks=k_step.step_masks(bit_pm, bond_par))
    else:
        step = k_step.fused_trotter_step
    if kick is None:
        kick = torch.ones((rows, steps, w), device=re.device)
        bond = torch.ones((rows, steps, nb), device=re.device)
    theta_col = theta_j_rows.reshape(rows, 1).contiguous()
    for s in range(steps):
        k_s, b_s = kick[:, s].contiguous(), bond[:, s].contiguous()
        with span("kicked.step"):
            re, im = step(re, im, k_s, b_s, theta_col, bit_pm, bond_par,
                          theta_h)
        after_step(s, re, im)
    return re, im


@dataclasses.dataclass
class EngineTables:
    """The engine's noise tables, on the engine's device.

    bond_probs [n_bonds, 16] f32: twirled Pauli probabilities of each
    bond's CX (index 4·p_a + p_b); confusion [nq, 2, 2] f32 readout
    assignment matrices M[meas, true], or None without readout error.
    Derived from confusion when the tables are made: readout [2, nq] f32,
    each qubit's (a, b) of :func:`~.density.readout_affine` (computed in
    float64), which map a row's ⟨Z_q⟩ and total T to a·⟨Z_q⟩ + b·T.
    """

    bond_probs: torch.Tensor
    confusion: Optional[torch.Tensor]
    readout: Optional[torch.Tensor] = dataclasses.field(init=False,
                                                        repr=False)

    def __post_init__(self):
        if self.confusion is None:
            self.readout = None
            return
        ab = [readout_affine(c) for c in self.confusion.cpu().numpy()]
        self.readout = torch.as_tensor(
            np.ascontiguousarray(np.array(ab, np.float32).T),
            device=self.confusion.device)


@dataclasses.dataclass
class KickedIsingEngine:
    """Noisy + ideal per-qubit-Z label generator for the TFIM family.

    ``device`` is the torch device everything runs on. The evolution is K1
    (:func:`~.kernels.evolve.evolve_fused`) up to nq = 13, and
    :func:`kicked_steps` above it: K3 a step at a time. ``use_kernel``:
    None runs the CUDA kernels on a CUDA device and their plain PyTorch
    versions on the CPU; True asks for the kernels (CUDA only); False runs
    the plain versions anywhere.
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
        with span("kicked.engine"):
            self._build()

    def _build(self):
        """Checks the arguments; builds the noise and sign tables on the
        device."""
        self.device = torch.device(self.device)
        if self.nq > 30:
            raise ValueError("statevector width limit (use the sharded or "
                             "Pauli-propagation engines beyond ~30q)")
        if self.use_kernel and self.device.type != "cuda":
            raise ValueError("use_kernel=True needs a CUDA device, got "
                             f"{self.device}")
        # the wrappers run the kernels on CUDA tensors and the plain
        # versions on CPU ones; False asks for the plain versions anywhere
        self._use_kernel = self.use_kernel is not False
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

        # K1 takes the tables transposed, [nq, dim] and [nb, dim];
        # kicked_steps (K3) takes them as built, [dim, nq], [dim, nb]
        self._fused = self.nq <= k_evolve.MAX_NQ
        if self._fused:
            self._bit_pm_t = dev(bit_pm.T)
            self._bond_par_t = dev(bond_par.T)
        else:
            self._bit_pm = dev(bit_pm)
            self._bond_par = dev(bond_par)
        self._neg_bit_pm = dev(-bit_pm)     # ⟨Z_q⟩ = probs @ (−bit_pm)
        # with readout, one more column of ones: the row's total T
        self._z_total = (None if ro is None else dev(np.hstack(
            [-bit_pm, np.ones((2 ** self.nq, 1), np.float32)])))

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
        X-flip signs [rows, nq] that correct ⟨Z_q⟩
        (:func:`propagate_frames`).
        """
        S, rows, nb, _ = draws.shape
        kick, bond, x_after = propagate_frames(draws, self.bonds, self.nq)
        qs = torch.arange(self.nq, dtype=torch.int32, device=draws.device)
        flip = (1 - 2 * ((x_after[-1][:, None] >> qs) & 1)).float()
        return (kick.reshape(rows, S * self.nq), bond.reshape(rows, S * nb),
                flip)

    # ------------------------------------------------------------------
    # (c) evolution
    # ------------------------------------------------------------------
    def evolve(self, theta_h: float, theta_j_rows: torch.Tensor,
               kick: Optional[torch.Tensor] = None,
               bond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Evolve |0…0⟩ per row; returns probabilities [rows, 2^nq].

        ``kick`` [rows, steps·nq] and ``bond`` [rows, steps·nb] are the ±1
        signs, or None for all +1 (the ideal arm). The probabilities are
        computed in place in the evolved re plane.
        """
        rows, S, nb = theta_j_rows.shape[0], self.steps, len(self.bonds)
        if self._fused:
            re, im = basis_planes(rows, self.nq, self.device)
            if kick is None:
                kick = torch.ones((rows, S * self.nq), device=self.device)
                bond = torch.ones((rows, S * nb), device=self.device)
            fn = (k_evolve.evolve_fused if self._use_kernel
                  else k_evolve.evolve_fused_reference)
            re, im = fn(re, im, kick, bond,
                        theta_j_rows.reshape(rows, 1).contiguous(),
                        self._bit_pm_t, self._bond_par_t, theta_h, S,
                        self.nq, nb)
        else:
            re, im = kicked_steps(
                *basis_planes(rows, self.nq, self.device),
                None if kick is None else kick.reshape(rows, S, -1),
                None if bond is None else bond.reshape(rows, S, -1),
                theta_j_rows, self._bit_pm, self._bond_par, theta_h, S,
                use_kernel=self._use_kernel)
        return re.mul_(re).addcmul_(im, im)

    # ------------------------------------------------------------------
    # (d) ⟨Z⟩, readout, frame flip, shots
    # ------------------------------------------------------------------
    def trajectory_z(self, probs: torch.Tensor, flip: torch.Tensor
                     ) -> torch.Tensor:
        """Each trajectory's ⟨Z_q⟩ [B, n_traj, nq]: ⟨Z⟩ of the
        probabilities, readout confusion, then the frame flip.

        Qubit q's confusion acts on its marginal alone, so the confused
        ⟨Z_q⟩ is a_q·⟨Z_q⟩ + b_q·T (``tables.readout``), T the row's total:
        one reduction of ``probs`` against [−bit_pm | 1] gives both. The
        confusion comes before the flip, as in the JAX engine.
        """
        check_ieee_matmul(probs)
        if self.tables.confusion is None:
            z = probs @ self._neg_bit_pm
        else:
            with span("kicked.confusion"):
                zt = probs @ self._z_total
                a, b = self.tables.readout
                z = torch.addcmul(zt[:, self.nq:] * b, zt[:, :self.nq], a)
        return z.mul_(flip).reshape(-1, self.n_traj, self.nq)

    def shot_labels(self, z: torch.Tensor, generator: torch.Generator
                    ) -> torch.Tensor:
        """Noisy ⟨Z_q⟩ [B, nq] from the trajectories' [B, n_traj, nq]:
        their mean, or binomial shots split over them."""
        if self.shots is None:
            return z.mean(dim=1)
        shots_per_traj = max(1, self.shots // self.n_traj)
        p1 = ((1.0 - z) / 2.0).clamp(0.0, 1.0)
        counts = torch.binomial(torch.full_like(p1, float(shots_per_traj)),
                                p1, generator=generator)
        return (1.0 - 2.0 * counts / shots_per_traj).mean(dim=1)

    # ------------------------------------------------------------------
    def run(self, J: torch.Tensor, generator: torch.Generator,
            mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ideal, noisy) ⟨Z_q⟩ [B, nq] for couplings J [B] on the device.

        Its stages are the spans ``kicked.frame``, ``kicked.evolve``,
        ``kicked.readout`` and ``kicked.ideal``.

        ``mesh`` (:func:`~..parallel.mesh.make_mesh`) shards the batch over
        its dp ranks: every rank draws the whole batch's noise from
        ``generator`` and keeps its rows (:func:`~..parallel.mesh.
        shard_rows`), evolves them, and the trajectories' ⟨Z⟩ and the
        ideal labels are all-gathered before the shots, which are drawn
        for the whole batch. So every rank returns what the unsharded
        call returns, shots included.
        """
        B, T = J.shape[0], self.n_traj
        theta_h = 2.0 * self.h * self.dt

        def gather(x):
            return x if mesh is None else gather_rows(x, mesh, B)

        with span("kicked.frame"):
            draws = self.sample_draws(B * T, generator)
            if mesh is not None:
                rows = shard_rows(B, mesh).to(J.device)
                J = J[rows]
                draws = draws[:, (rows[:, None] * T + torch.arange(
                    T, device=J.device)).reshape(-1)]
            theta_j = (-2.0 * self.dt) * J.to(torch.float32)
            kick, bond, flip = self.frame_signs(draws)
            del draws
        with span("kicked.evolve"):
            probs = self.evolve(theta_h, theta_j.repeat_interleave(T), kick,
                                bond)
            del kick, bond
        with span("kicked.readout"):
            z = gather(self.trajectory_z(probs, flip))
            del probs
            noisy = self.shot_labels(z, generator)
        # ideal labels: the same evolution with every sign +1, one row per
        # circuit
        with span("kicked.ideal"):
            probs = self.evolve(theta_h, theta_j)
            check_ieee_matmul(probs)
            ideal = gather(probs @ self._neg_bit_pm)
        return ideal, noisy

    def generate(self, J_values: np.ndarray, seed: int = 0, mesh=None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """(ideal, noisy) per-qubit ⟨Z⟩ as numpy [B, nq]; noise from seed.

        With ``mesh`` the batch is sharded over its dp ranks and every rank
        returns the whole batch's labels, equal to the unsharded call's
        (:meth:`run`).
        """
        with span("kicked.generate"):
            generator = torch.Generator(device=self.device)
            generator.manual_seed(seed)
            J = torch.as_tensor(np.asarray(J_values, np.float32),
                                device=self.device)
            ideal, noisy = self.run(J, generator, mesh=mesh)
            return ideal.cpu().numpy(), noisy.cpu().numpy()
