"""The (ideal, noisy) label pipeline for a parameterized circuit template.

Counterpart of ``mlqem_tpu/parallel/datagen.py``. A parameterized family
(here the TFIM Trotter circuit) tensorizes once into a template; a batch of
Hamiltonian parameters binds into it on the device, and the whole label
pipeline runs as batched torch work:

(a) the noise tables, on the host, once per pipeline: per-op twirled Pauli
    probabilities (:func:`twirled_noise_tables`), the density-matrix
    engine's superoperator table (:func:`compile_noise_table`) and readout
    confusion;
(b) for the trajectory methods, the Pauli draws of every (circuit,
    trajectory, op), then, for ``method="frame"``, the integer frame walk
    and the sign-folded angles (:func:`frame_theta_eff`); for
    ``density_matrix``, the op unitaries and the fused superop plan
    (:func:`superop_plan`);
(c) the noisy evolution: kernel K2 (:func:`evolve_frame_marginals`) for
    ``frame``, the gather trajectory engine for ``trajectory_gather``, the
    superop sweep (:func:`apply_plan`) for ``density_matrix``;
(d) the frame flip, readout confusion, ⟨Z⟩ and binomial shots; for
    ``density_matrix``, readout confusion on the exact distribution, then
    ⟨Z⟩ or joint shots;
(c') the ideal arm: the statevector of every bound circuit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..circuits.families import IsingModel, IsingOptions
from ..circuits.parameters import (CircuitTemplate, Parameter,
                                   tensorize_template)
from ..device.model import DeviceModel
from ..device.noise import NoiseModel, compile_noise_table, readout_matrices
from ..ops import sampling
from ..ops.density import apply_readout_confusion, dm_probabilities
from ..ops.density_static import apply_plan, superop_plan
from ..ops.frame_trajectory import (frame_marginals_to_z, frame_supported,
                                    frame_theta_eff)
from ..ops.kernels.frame_evolve import (evolve_frame_marginals,
                                        evolve_frame_marginals_reference)
from ..ops.statevector import probabilities, statevector, z_expectations
from ..ops.trajectory import (run_trajectories_presampled,
                              twirled_noise_tables)
from ..utils.profiling import span
from .mesh import gather_rows, shard_rows

METHODS = ("density_matrix", "trajectory", "trajectory_gather", "frame")


def choose_noisy_engine(method: str, device_type: str, nq: int,
                        frame_ok: bool, use_kernel: Optional[bool]
                        ) -> Tuple[str, str]:
    """(method, engine) a pipeline runs, chosen by width at construction.

    The engines: ``"density_matrix"``, ``"trajectory_gather"``, ``"k2"``
    (K2's wrapper: the kernel on CUDA tensors, its plain version on CPU
    ones) and ``"k2_plain"`` (K2's plain version anywhere,
    ``use_kernel=False``). ``"frame"`` runs K2 at every width it takes
    (≤ 30 qubits, what ``frame_ok`` says). ``"trajectory"`` becomes
    ``"frame"`` on a CUDA device for a frame-supported template, at every
    width, as the JAX package does on its accelerator; elsewhere
    ``"trajectory_gather"``. ``use_kernel=True`` raises unless the engine
    is ``"k2"``.
    """
    if method == "trajectory":
        method = ("frame" if device_type == "cuda" and frame_ok
                  else "trajectory_gather")
    engine = method
    if method == "frame":
        engine = "k2_plain" if use_kernel is False else "k2"
    if use_kernel and engine != "k2":
        raise ValueError(f"use_kernel=True asks for K2, but nq={nq} with "
                         f"this method runs {engine!r}")
    return method, engine


def make_ising_template(nq: int, steps: int, basis: str = "Z",
                        dt: float = 0.25, h: Optional[float] = None
                        ) -> CircuitTemplate:
    """Parameterized TFIM Trotter template: J (and optionally h) symbolic."""
    J = Parameter("J")
    hp = Parameter("h") if h is None else h
    ops = IsingOptions(nq=nq, h=hp, J=J, dt=dt, depth=steps,
                       measure_basis=basis)
    qc = IsingModel.make_circuit(ops, measure=False)
    return tensorize_template(qc)


@dataclasses.dataclass
class PipelineTables:
    """The pipeline's noise tables, on the pipeline's device.

    pauli_probs [L, 16] f32: twirled Pauli probabilities after each op of
    the template (index 4·p_a + p_b); confusion [nq, 2, 2] f32 readout
    assignment matrices M[meas, true], or None without readout error.
    """

    pauli_probs: torch.Tensor
    confusion: Optional[torch.Tensor]


@dataclasses.dataclass
class IsingLabelPipeline:
    """(ideal, noisy) per-qubit-Z label generator for the TFIM template.

    ``device`` is the torch device everything runs on. ``method``:

    * ``"frame"``: Pauli-frame trajectories (rotation+Clifford circuits)
      through kernel K2 on a CUDA device, its plain version on the CPU;
    * ``"trajectory_gather"``: the gather trajectory engine (any gate set);
    * ``"trajectory"``: ``"frame"`` on a CUDA device when the template is
      frame-supported (K2 takes every width up to 30 qubits), else
      ``"trajectory_gather"``;
    * ``"density_matrix"`` (the default, as in the JAX package): the
      exact noisy density matrix of every circuit (the static superop
      engine), readout confusion, then ⟨Z⟩ or joint shots. ``n_traj``
      and ``use_kernel`` do not apply.

    ``use_kernel``: None calls K2's wrapper (the kernel on a CUDA device,
    its plain version on the CPU); True asks for the kernel (CUDA only, and
    only where the method runs it); False runs the plain version anywhere.
    The read-only ``noisy_engine`` names what the noisy evolution runs
    (:func:`choose_noisy_engine`).
    """

    device_model: DeviceModel
    nq: int
    steps: int
    device: Union[str, torch.device]
    dt: float = 0.25
    h: Optional[float] = 1.0   # None → symbolic (pass h_values at generate)
    shots: Optional[int] = 10000
    readout: bool = True
    noise_model: Optional[NoiseModel] = None
    method: str = "density_matrix"
    n_traj: int = 100
    use_kernel: Optional[bool] = None

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}, got "
                             f"{self.method!r}")
        if self.use_kernel and self.device.type != "cuda":
            raise ValueError("use_kernel=True needs a CUDA device, got "
                             f"{self.device}")
        self.template = make_ising_template(self.nq, self.steps, "Z",
                                            self.dt, h=self.h)
        nm = self.noise_model or NoiseModel.from_device(self.device_model)
        # shared topology → the noise keys are identical across the batch
        self.ct_struct = self.template.bind_host(
            np.zeros(self.template.num_parameters, np.float32))
        # the density-matrix engine's superoperator table
        self._keys, self._table = compile_noise_table(self.ct_struct, nm)
        ro = readout_matrices(nm, self.nq) if self.readout else None
        self.tables = PipelineTables(
            torch.as_tensor(twirled_noise_tables(self.ct_struct, nm),
                            device=self.device),
            None if ro is None else torch.as_tensor(
                np.asarray(ro, np.float32), device=self.device))
        supported = frame_supported(self.ct_struct, self.nq)
        if self.method == "frame" and not supported:
            raise ValueError(
                "method='frame' needs rotations + Cliffords (gate set "
                "{id,x,y,z,h,s,sdg,t,tdg,sx,sxdg,rx,ry,rz,p,rzz,cx,cy,cz,"
                "swap}, <=30 qubits)")
        self.method, self._engine = choose_noisy_engine(
            self.method, self.device.type, self.nq, supported,
            self.use_kernel)

    @property
    def noisy_engine(self) -> str:
        """What runs the noisy evolution (:func:`choose_noisy_engine`)."""
        return self._engine

    def sample_draws(self, batch: int, generator: torch.Generator
                     ) -> torch.Tensor:
        """The 2q Pauli after every op of every trajectory: int32
        [batch, n_traj, L] (index 4·p_a + p_b on the op's qubits)."""
        return sampling.sample_small_categorical(
            self.tables.pauli_probs[None, None],
            (batch, self.n_traj, self.ct_struct.max_ops), generator)

    def run(self, params: torch.Tensor, generator: torch.Generator,
            mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ideal, noisy) ⟨Z_q⟩ [B, nq] for template values params [B, P]
        on the device.

        The stages of the module's docstring are the spans
        ``pipeline.frame`` (b), ``pipeline.evolve`` (c),
        ``pipeline.readout`` (d) and ``pipeline.ideal`` (c')
        (:func:`~..utils.profiling.span`).

        ``mesh`` (:func:`~.mesh.make_mesh`) shards the batch over its dp
        ranks: every rank draws the whole batch's Paulis from
        ``generator`` and keeps its rows (:func:`~.mesh.shard_rows`), and
        what the shots read (each trajectory's ⟨Z⟩, or the exact outcome
        distribution) and the ideal labels are all-gathered before the
        shots, which are drawn for the whole batch. So every rank returns
        what the unsharded call returns, shots included.
        """
        B, nq, T = params.shape[0], self.nq, self.n_traj
        method, confusion = self.method, self.tables.confusion

        def gather(x):
            return x if mesh is None else gather_rows(x, mesh, B)

        with span("pipeline.frame"):
            choices = (None if method == "density_matrix"
                       else self.sample_draws(B, generator))
            if mesh is not None:
                rows = shard_rows(B, mesh).to(params.device)
                params = params[rows]
                choices = None if choices is None else choices[rows]
            ct = self.template.bind(params)             # params [b, L, 3]
            if method == "density_matrix":
                plan = superop_plan(self.ct_struct, ct.params, self._keys,
                                    self._table)
            elif method == "frame":
                theta_eff, fx, plan = frame_theta_eff(self.ct_struct,
                                                      ct.params, choices)
                del choices
        with span("pipeline.evolve"):
            if method == "density_matrix":
                dms = apply_plan(plan, ct.params.shape[0], max(nq, 2),
                                 self.device)
                probs = dm_probabilities(dms)
                del dms
            elif method == "frame":
                evolve = (evolve_frame_marginals if self._engine == "k2"
                          else evolve_frame_marginals_reference)
                p1 = evolve(theta_eff, plan, nq)
                del theta_eff
            else:
                states = run_trajectories_presampled(self.ct_struct,
                                                     ct.params, choices, nq)
                del choices
                probs = probabilities(states)
                del states
        with span("pipeline.readout"):
            if method == "density_matrix":
                if confusion is not None:
                    probs = apply_readout_confusion(probs, confusion, nq)
                noisy = self._density_shots(gather(probs), generator)
            else:
                if method == "frame":
                    z_traj = frame_marginals_to_z(
                        p1.reshape(ct.params.shape[0], T, nq), fx, confusion)
                else:
                    if confusion is not None:
                        probs = apply_readout_confusion(probs, confusion, nq)
                    z_traj = z_expectations(probs, nq)      # [b, T, nq]
                noisy = self._trajectory_shots(gather(z_traj), generator)
        with span("pipeline.ideal"):
            ideal = gather(z_expectations(probabilities(statevector(ct)),
                                          nq))
        return ideal, noisy

    def _density_shots(self, probs: torch.Tensor,
                       generator: torch.Generator) -> torch.Tensor:
        """Noisy ⟨Z_q⟩ [B, nq]: exact (``shots=None``) or joint shots read
        bit by bit."""
        if self.shots is None:
            return z_expectations(probs, self.nq)
        return sampling.sampled_z_expectations(probs, self.shots, self.nq,
                                               generator)

    def _trajectory_shots(self, z_traj: torch.Tensor,
                          generator: torch.Generator) -> torch.Tensor:
        """Noisy ⟨Z_q⟩ [B, nq]: the trajectories' mean, or binomial shots
        split over them."""
        if self.shots is None:
            return z_traj.mean(dim=1)
        # the <Z_q> estimate from S joint samples is marginally
        # Binomial(S, p1_q): sample that per qubit
        shots_per_traj = max(1, self.shots // self.n_traj)
        p1 = ((1.0 - z_traj) / 2.0).clamp(0.0, 1.0)
        counts = torch.binomial(
            torch.full_like(p1, float(shots_per_traj)), p1,
            generator=generator)
        return (1.0 - 2.0 * counts / shots_per_traj).mean(dim=1)

    def params_from_values(self, J_values: np.ndarray,
                           h_values: Optional[np.ndarray] = None
                           ) -> np.ndarray:
        """Template values [B, P] (float32) in the template's parameter
        order."""
        cols = []
        for p in self.template.parameters:
            if p.name == "J":
                cols.append(np.asarray(J_values, np.float32))
            elif p.name == "h":
                if h_values is None:
                    raise ValueError("template has symbolic h; pass h_values")
                cols.append(np.asarray(h_values, np.float32))
        return np.stack(cols, axis=-1)

    def generate(self, J_values: np.ndarray,
                 h_values: Optional[np.ndarray] = None, seed: int = 0,
                 mesh=None) -> Tuple[np.ndarray, np.ndarray]:
        """(ideal[B, nq], noisy[B, nq]) as numpy for a batch of Hamiltonian
        params; the noise comes from a generator seeded with ``seed``.
        With ``mesh`` the batch is sharded over its dp ranks and every rank
        returns the whole batch's labels, equal to the unsharded call's
        (:meth:`run`)."""
        params = self.params_from_values(J_values, h_values)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        ideal, noisy = self.run(torch.as_tensor(params, device=self.device),
                                generator, mesh=mesh)
        return ideal.cpu().numpy(), noisy.cpu().numpy()
