"""Exact light-cone engine: per-step ⟨Z_q⟩ of the TFIM Trotter circuit at
any chain width (counterpart of ``mlqem_tpu/ops/lightcone.py``).

The backward cone of a single ``Z_q`` grows by at most one qubit per side
per Trotter step, so after ``s`` steps ⟨Z_q⟩ depends only on the gates
inside the window ``[q−s, q+s]``. Simulating that window with open ends is
exact, for the ideal circuit and, trajectory by trajectory, under
stochastic Pauli noise. At demo1's 100 qubits and 10 steps a window holds
21 qubits.

The circuit and noise conventions are those of
:class:`~.kicked_ising.KickedIsingEngine` (θ_J = −2·J·dt, θ_h = 2·h·dt;
a step is the RX kick, then the even bonds, then the odd bonds; each bond
is cx → noise → rz(θ_J on the target) → cx → noise). Noise enters as
per-trajectory ±1 angle signs from the Pauli-frame pass plus a per-step
measurement flip.

:meth:`LightconeIsing.evolve_stepwise` evolves a window one step at a time
through :func:`~.kicked_ising.kicked_steps` (K3 at every width: its chip
tier up to 14 qubits, its wide tier in passes over device memory above)
and reads ⟨Z_obs⟩ after each. The wrapper picks kernel or plain version by
the tensors' device.

Spans (:func:`~..utils.profiling.span`, recorded only while a profiler
runs or under :func:`~..utils.profiling.tracing`): ``lightcone.
generate_stepwise`` (a request); ``lightcone.tables`` (a window's tables,
each bond's twirl inside as ``trajectory.twirl``); ``lightcone.chunk``
(:meth:`~LightconeIsing.run_noisy`, one chunk of the noisy arm) with
``lightcone.frame``, ``lightcone.evolve`` and ``lightcone.shots`` inside;
``lightcone.ideal`` (the ideal arm). Inside an evolution each step is
``kicked.step`` and each ⟨Z_obs⟩ read ``lightcone.z``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device.model import DeviceModel
from ..device.noise import NoiseModel
from . import sampling
from .density import readout_affine
from ..utils.profiling import span
from .kernels import frames as k_frames
from .kicked_ising import basis_planes, kicked_steps
from .trajectory import compose_pauli_channel, pauli_channel_probs


def cone_window(q: int, steps: int, nq: int) -> Tuple[int, int]:
    """(start, width) of the radius-``steps`` cone of qubit ``q``, clamped
    to the chain (width = min(2·steps+1, nq))."""
    w = min(2 * steps + 1, nq)
    start = min(max(q - steps, 0), nq - w)
    return start, w


def _z_obs(re: torch.Tensor, im: torch.Tensor, mz: torch.Tensor
           ) -> torch.Tensor:
    """Σ_j |ψ_j|²·mz_j per row, elementwise (IEEE f32 under any matmul
    precision setting)."""
    probs = re * re
    return probs.addcmul_(im, im).mul_(mz).sum(dim=-1)


@dataclasses.dataclass
class LightconeIsing:
    """Stepwise noisy + ideal ⟨Z_q⟩ for the TFIM family at any width.

    One statevector evolution per (window, arm). ``shots`` is per
    trajectory (hardware semantics: ``n_traj`` error realizations ×
    ``shots`` counts each, averaged); ``shots=None`` returns exact
    per-trajectory values. ``t_chunk`` bounds the trajectories evolved at
    once (the state block is [B·t_chunk, 2^w] complex: 2 GB at
    t_chunk=128, w=21); ``n_traj`` must split into equal chunks, which run
    in turn with independent noise draws and average exactly.

    ``device_model`` is the calibration and ``device`` the torch device
    everything runs on. ``use_kernel``: None runs the CUDA kernels on a
    CUDA device and the plain versions on the CPU; True asks for the
    kernels (CUDA only); False runs the plain versions anywhere.
    """

    device_model: DeviceModel
    nq: int
    steps: int
    device: Union[str, torch.device]
    dt: float = 0.25
    h: float = 1.0
    n_traj: int = 5
    shots: Optional[int] = 10000
    readout: bool = True
    noise_model: Optional[NoiseModel] = None
    noise: bool = True
    t_chunk: Optional[int] = None
    use_kernel: Optional[bool] = None

    def __post_init__(self):
        self.device = torch.device(self.device)
        if min(2 * self.steps + 1, self.nq) > 32:
            raise ValueError("light-cone window exceeds 32 qubits — "
                             "truncate steps or use sharded engines")
        if self.t_chunk is not None and self.n_traj % self.t_chunk:
            raise ValueError("n_traj must split into equal t_chunk blocks "
                             "(exact chunk-mean averaging)")
        if self.use_kernel and self.device.type != "cuda":
            raise ValueError("use_kernel=True needs a CUDA device, got "
                             f"{self.device}")
        nm = self.noise_model
        if nm is None and self.noise:
            nm = NoiseModel.from_device(self.device_model)
        self._nm = nm
        self._sign_cache: Dict = {}

    # -- per-window tables ---------------------------------------------------
    def window_tables(self, q: int) -> Dict:
        """Static and noise tables of qubit ``q``'s window (the JAX engine's
        ``_window_tables``): start, width w, the observable's local index,
        the local bonds in global application order (even sublayer first),
        their twirled CX Pauli probabilities [nb, 16] and the readout
        confusion of ``q``."""
        with span("lightcone.tables"):
            start, w = cone_window(q, self.steps, self.nq)
            even = [(a - start, a + 1 - start)
                    for a in range(0, self.nq - 1, 2)
                    if start <= a and a + 1 <= start + w - 1]
            odd = [(a - start, a + 1 - start)
                   for a in range(1, self.nq - 1, 2)
                   if start <= a and a + 1 <= start + w - 1]
            bonds = even + odd
            probs = []
            for (la, lb) in bonds:
                chan = None if self._nm is None else \
                    self._nm.channel_for("cx", (la + start, lb + start))
                p = (pauli_channel_probs(chan) if chan is not None
                     else np.eye(1, 16, 0)[0])
                probs.append(p.astype(np.float32))
            conf = None
            if (self.readout and self._nm is not None
                    and self._nm.readout is not None):
                conf = self._nm.readout[q]
            return {"start": start, "w": w, "obs": q - start, "bonds": bonds,
                    "probs": np.asarray(probs, np.float32).reshape(-1, 16),
                    "confusion": conf}

    def sign_tables(self, tw: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """±1 tables of a window shape on the device, built once: bit_pm
        [2^w, w] ((−1)^(1 − bit q)) and bond_par [2^w, nb] (its product on
        each bond). At w=21 they take 176 MB and 168 MB."""
        w, bonds = tw["w"], tuple(tw["bonds"])
        key = (w, bonds)
        if key not in self._sign_cache:
            lane = torch.arange(1 << w, dtype=torch.int32, device=self.device)
            qs = torch.arange(w, dtype=torch.int32, device=self.device)
            bit_pm = 2.0 * ((lane[:, None] >> qs) & 1).float() - 1.0
            a = torch.tensor([p for p, _ in bonds], dtype=torch.long,
                             device=self.device)
            b = torch.tensor([p for _, p in bonds], dtype=torch.long,
                             device=self.device)
            self._sign_cache[key] = (bit_pm,
                                     (bit_pm[:, a] * bit_pm[:, b]).contiguous())
        return self._sign_cache[key]

    # -- (b) frame pass -------------------------------------------------------
    def frame_signs(self, draws: torch.Tensor, tw: Dict
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The window's frames from draws [S, rows, nb, 2]: kick signs
        [rows, S, w], bond signs [rows, S, nb] and the measurement flip of
        the observable after each step [S, rows], all f32 ±1
        (:func:`~.kernels.frames.propagate_frames`, K5; its plain version
        with ``use_kernel=False``)."""
        fn = (k_frames.propagate_frames if self.use_kernel is not False
              else k_frames.propagate_frames_reference)
        kick, bond, x_after = fn(draws, tw["bonds"], tw["w"])
        flip = (1 - 2 * ((x_after >> tw["obs"]) & 1)).float()
        return kick, bond, flip

    # -- (c) evolution ----------------------------------------------------------
    def evolve_stepwise(self, tw: Dict, theta_j_rows: torch.Tensor,
                        kick: Optional[torch.Tensor] = None,
                        bond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Per-step ⟨Z_obs⟩ [S, rows] of |0…0⟩ evolved through the window.

        ``kick`` [rows, S, w] and ``bond`` [rows, S, nb] are the ±1 angle
        signs, or None for all +1 (the ideal arm). Each step is the span
        ``kicked.step``, each ⟨Z_obs⟩ read after it ``lightcone.z``.
        """
        w, obs, S = tw["w"], tw["obs"], self.steps
        rows = theta_j_rows.shape[0]
        bit_pm, bond_par = self.sign_tables(tw)
        mz = (-bit_pm[:, obs]).contiguous()
        z = torch.empty((S, rows), dtype=torch.float32, device=self.device)

        def read_z(s, re_, im_):
            with span("lightcone.z"):
                z[s] = _z_obs(re_, im_, mz)

        kicked_steps(*basis_planes(rows, w, self.device), kick, bond,
                     theta_j_rows, bit_pm, bond_par, 2.0 * self.h * self.dt, S,
                     use_kernel=self.use_kernel is not False,
                     after_step=read_z)
        return z

    # -- the arms ---------------------------------------------------------------
    def run_noisy(self, tw: Dict, theta_j: torch.Tensor,
                  probs: torch.Tensor, a: float, b: float,
                  generator: torch.Generator) -> torch.Tensor:
        """One chunk of the noisy arm of a window: θ_J [B] → [B, S].

        ``probs`` [nb, 16] are the window's CX Pauli probabilities and
        (a, b) its readout affine. The span ``lightcone.chunk``, with the
        stages ``lightcone.frame`` (draws and frame pass),
        ``lightcone.evolve`` (:meth:`evolve_stepwise`) and
        ``lightcone.shots`` inside.
        """
        S, B = self.steps, theta_j.shape[0]
        T = self.t_chunk if self.t_chunk is not None else self.n_traj
        with span("lightcone.chunk"):
            with span("lightcone.frame"):
                draws = sampling.sample_small_categorical(
                    probs[:, None, :], (S, B * T, len(tw["bonds"]), 2),
                    generator)
                kick, bond, flip = self.frame_signs(draws, tw)
                del draws
            with span("lightcone.evolve"):
                z_sim = self.evolve_stepwise(
                    tw, theta_j.repeat_interleave(T), kick, bond)
                del kick, bond
            with span("lightcone.shots"):
                # the frame flip is physical (the noise Pauli's X/Y
                # support commuted to the measurement): z_phys =
                # flip·z_sim, then readout, then counts
                z = (flip * z_sim).mul_(float(np.float32(a))).add_(
                    float(np.float32(b)))
                if self.shots is not None:
                    p1 = ((1.0 - z) / 2.0).clamp_(0.0, 1.0)
                    counts = torch.binomial(
                        torch.full_like(p1, float(self.shots)), p1,
                        generator=generator)
                    z = 1.0 - 2.0 * counts / self.shots
                return z.reshape(S, B, T).mean(dim=2).T

    def _generator(self, seed: int, q: int, ns: int, chunk: int
                   ) -> torch.Generator:
        """The noise and shot stream of (seed, qubit, noise factor, chunk):
        the JAX engine's key ``seed·7919 + q·131 + ns``, with the chunk
        folded in, so a call repeats exactly and chunks draw independently."""
        words = np.random.SeedSequence(
            [(seed * 7919 + q * 131 + ns) % 2 ** 32, chunk]
        ).generate_state(2, np.uint32)
        gen = torch.Generator(device=self.device)
        gen.manual_seed((int(words[0]) << 31) ^ int(words[1]))
        return gen

    def _theta_j(self, J_values) -> torch.Tensor:
        return torch.as_tensor(-2.0 * self.dt
                               * np.asarray(J_values, np.float32),
                               device=self.device)

    def ideal_stepwise(self, J_values: np.ndarray,
                       qubits: Optional[Sequence[int]] = None
                       ) -> np.ndarray:
        """Noise-free per-step ⟨Z_q⟩ [B, steps, Q]: one row per circuit,
        every sign +1, no readout or shots."""
        qubits = list(qubits) if qubits is not None else list(range(self.nq))
        theta_j = self._theta_j(J_values)
        out = torch.stack([self.evolve_stepwise(self.window_tables(q),
                                                theta_j).T for q in qubits],
                          dim=-1)
        return out.cpu().numpy()

    def generate_stepwise(self, J_values: np.ndarray,
                          noise_scale: float = 1.0,
                          qubits: Optional[Sequence[int]] = None,
                          seed: int = 0,
                          want_ideal: bool = True,
                          readout_correct: bool = False
                          ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """(noisy [B, steps, Q], ideal [B, steps, Q] or None): exact per-step
        ⟨Z_q⟩ through every depth ≤ ``steps``.

        ``noise_scale`` composes each CX channel with itself (ZNE local
        folding; integer factors only). ``want_ideal=False`` skips the
        noise-free arm. ``readout_correct=True`` inverts the readout affine
        on the estimates, z ← (z_meas − b)/a per qubit (TREX): the shot
        noise is still drawn on the confused probabilities.
        """
        with span("lightcone.generate_stepwise"):
            qubits = (list(qubits) if qubits is not None
                      else list(range(self.nq)))
            theta_j = self._theta_j(J_values)
            B = theta_j.shape[0]
            noisy = np.empty((B, self.steps, len(qubits)), np.float32)
            ideal = np.empty((B, self.steps, len(qubits)), np.float32) \
                if want_ideal else None
            ns = int(round(noise_scale))
            if abs(noise_scale - ns) > 1e-9:
                raise ValueError(
                    f"noise_scale={noise_scale} — channel self-composition "
                    "(local folding) only amplifies by integer factors; use "
                    "integer ZNE noise factors with this engine")
            n_chunks = (self.n_traj // self.t_chunk
                        if self.t_chunk is not None else 1)
            for qi, q in enumerate(qubits):
                tw = self.window_tables(q)
                probs = tw["probs"]
                if ns != 1:
                    probs = np.stack([compose_pauli_channel(
                        p.astype(np.float64), ns) for p in probs]
                    ).astype(np.float32).reshape(probs.shape)
                probs_t = torch.as_tensor(probs, device=self.device)
                a, b = readout_affine(tw["confusion"])
                outs = [self.run_noisy(tw, theta_j, probs_t, a, b,
                                       self._generator(seed, q, ns, tc))
                        for tc in range(n_chunks)]
                if want_ideal:
                    with span("lightcone.ideal"):
                        z_ideal = self.evolve_stepwise(tw, theta_j)
                    ideal[:, :, qi] = z_ideal.T.cpu().numpy()
                acc = outs[0].cpu().numpy().astype(np.float64)
                for n in outs[1:]:
                    acc += n.cpu().numpy()
                noisy[:, :, qi] = acc / n_chunks
                if readout_correct and (a, b) != (1.0, 0.0):
                    noisy[:, :, qi] = (noisy[:, :, qi] - b) / a
            return noisy, ideal
