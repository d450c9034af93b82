"""Experiment datasets: the notebook-layer data-generation workflows.

Counterpart of ``mlqem_tpu/workflows/datasets.py``. Rebuilds the
reference's dataset notebooks as functions:

* :func:`ising_dataset` — ``h13_ising_data_gen``: TFIM Trotter circuits over
  (J, steps, measure-basis) with three noise settings ('device' as-is /
  'coherent' CX over-rotation / 'no_readout') and per-qubit Z labels.
* :func:`mbl_dataset` — ``h02_mbd_data_gen``: MBL Floquet circuits,
  per-qubit ⟨Z⟩ + charge-imbalance targets (``broken_connections`` gives
  the ``h06`` variant with removed CZ bonds).
* :func:`tiling_dataset` — ``h05``: small active circuits embedded in a
  larger register.
* :func:`random_circuit_dataset` — ``h38`` / ``02_data_generation``.

The circuits are drawn on the host with numpy exactly as the JAX package
draws them, so one seed builds the same circuits in both packages. The
labels run on ``device`` (the card unless the caller asks for the CPU):
an exact statevector for the ideal arm and the gather density-matrix
engine for the noisy one. Every function returns plain numpy arrays and
the circuits, ready for ``encode_data``/graph encoding and the trainers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..circuits.circuit import Circuit, CircuitTensor, stack_circuits
from ..circuits.families import (IsingModel, IsingOptions,
                                 construct_mbl_circ_with_cut,
                                 construct_mbl_circuit, construct_tiling,
                                 generate_disorder, ising_init_prefix_4q,
                                 random_circuit)
from ..data.encoders import calc_imbalance
from ..device.model import DeviceModel
from ..device.noise import NoiseModel, add_coherent_cx_noise, \
    compile_noise_table
from ..ops.density import (apply_readout_confusion, batch_density_matrices,
                           dm_probabilities)
from ..ops.sampling import sampled_z_expectations
from ..ops.statevector import (batch_statevectors, probabilities,
                               z_expectations)
from ..transpile.lower import transpile

Device = Union[str, torch.device]


def noise_setting(device_model: DeviceModel, setting,
                  theta: float = 0.05 * np.pi,
                  seed: Optional[int] = None,
                  scale: float = 1.0) -> NoiseModel:
    """The reference's three noise settings (``h13``):
    'device' (FakeLima as-is), 'coherent' (CX over-rotation via AddNoise),
    'no_readout' (RemoveReadoutErrors).

    A prebuilt :class:`NoiseModel` passes through unchanged — use this to
    share ONE noise realization (e.g. the coherent setting's per-edge
    random thetas) across train/test/ZNE stages of an experiment.

    ``scale`` is a global channel-strength multiplier (gate errors, gate
    durations for relaxation, readout flip probability, over-rotation
    angle) used to calibrate the simulated regime to a published noisy
    baseline.
    """
    if isinstance(setting, NoiseModel):
        return setting
    if setting == "device":
        return NoiseModel.from_device(device_model, scale=scale)
    if setting == "coherent":
        return add_coherent_cx_noise(device_model, theta=theta * scale,
                                     uniform=False,
                                     add_depolarization=True,
                                     add_coherent=True, seed=seed,
                                     scale=scale)
    if setting == "no_readout":
        return NoiseModel.from_device(device_model,
                                      scale=scale).without_readout()
    raise ValueError(f"unknown noise setting {setting!r}")


# Device memory budget of one chunk's density matrices (complex64,
# 2^(2n)·8 bytes a circuit). The gather engine holds a few copies of the
# batch while it applies an op, so a chunk peaks at several GiB.
_ZQ_DM_BYTES = 1 << 30


def _zq_chunk(num_qubits: int) -> int:
    """Circuits per chunk of :func:`_zq_labels` at ``num_qubits``."""
    n = max(num_qubits, 2)                 # the simulators' width
    return max(1, _ZQ_DM_BYTES // (8 << (2 * n)))


def _zq_labels(circuits: Sequence[Circuit], device_model: DeviceModel,
               noise_model: NoiseModel, shots: Optional[int],
               seed: int, ideal: bool = True,
               ideal_shots: Optional[int] = None,
               device: Device = "cuda"
               ) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """(ideal[B, nq] or None, noisy[B, nq]) per-qubit Z labels.

    One statevector pass and ONE noisy density-matrix evolution serve all
    nq single-Z observables, and all qubits read off a shared shot record —
    the hardware/counts semantics (``cal_all_z_exp``, one counts dict per
    circuit).

    ``ideal_shots`` samples the ideal labels too (the reference's ideal
    arm is a noiseless counts run at 10k shots, so its train labels carry
    an ≈1/√shots noise floor; exact ideal labels are the default).

    The batch is stacked once at the global op padding and evaluated in
    chunks of :func:`_zq_chunk` circuits, which bound the density matrices'
    device memory (``_ZQ_DM_BYTES``). A chunk's sampling generator is
    seeded ``seed + 7·chunk_index`` (the ideal shots' ``+ 7919`` on top),
    as in the JAX package: chunk keys never collide with the dataset
    builders' seed, seed+1, seed+2 offsets.
    """
    device = torch.device(device)
    nq = circuits[0].num_qubits
    B = len(circuits)
    ct = stack_circuits(list(circuits))
    keys, table = compile_noise_table(ct, noise_model)
    confusion = (torch.as_tensor(np.asarray(noise_model.readout[:nq],
                                            np.float32), device=device)
                 if noise_model is not None
                 and noise_model.readout is not None else None)

    def generator(chunk_seed: int) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(chunk_seed)

    def eval_chunk(ct_c: CircuitTensor, keys_c, chunk_seed: int):
        ideal_c = None
        if ideal:
            iprobs = probabilities(batch_statevectors(ct_c, device))
            ideal_c = (z_expectations(iprobs, nq) if ideal_shots is None
                       else sampled_z_expectations(
                           iprobs, int(ideal_shots), nq,
                           generator(chunk_seed + 7919)))
            ideal_c = ideal_c.cpu().numpy().astype(np.float64)
        probs = dm_probabilities(batch_density_matrices(ct_c, keys_c, table,
                                                        device))
        if confusion is not None:
            probs = apply_readout_confusion(probs, confusion, nq)
        if shots is None:
            noisy_c = z_expectations(probs, nq)
        else:
            noisy_c = sampled_z_expectations(probs, int(shots), nq,
                                             generator(chunk_seed))
        return ideal_c, noisy_c.cpu().numpy().astype(np.float64)

    chunk = _zq_chunk(nq)
    if B <= chunk:
        return eval_chunk(ct, keys, seed)
    ideal_parts, noisy_parts = [], []
    for c0 in range(0, B, chunk):
        sl = slice(c0, min(c0 + chunk, B))
        ct_c = CircuitTensor(ct.gate_ids[sl], ct.qubits[sl], ct.params[sl],
                             nq)
        i_c, n_c = eval_chunk(ct_c, keys[sl], seed + 7 * (c0 // chunk))
        ideal_parts.append(i_c)
        noisy_parts.append(n_c)
    ideal_vals = np.concatenate(ideal_parts) if ideal else None
    return ideal_vals, np.concatenate(noisy_parts)


@dataclasses.dataclass
class LabeledDataset:
    circuits: List[Circuit]
    ideal: np.ndarray          # [B, nq]
    noisy: np.ndarray          # [B, nq]
    meta: List[dict]

    def __len__(self):
        return len(self.circuits)


def _path_layout(device_model: DeviceModel, k: int) -> Optional[List[int]]:
    """A simple path of k physical qubits in the coupling graph (DFS,
    deterministic) — the natural line embedding qiskit's layout passes
    find for chain circuits. None if the graph has no k-path."""
    adj: Dict[int, List[int]] = {}
    for a, b in device_model.coupling_map:
        adj.setdefault(int(a), []).append(int(b))
    for v in adj.values():
        v.sort()

    def dfs(path, seen):
        if len(path) == k:
            return path
        for nxt in adj.get(path[-1], []):
            if nxt not in seen:
                r = dfs(path + [nxt], seen | {nxt})
                if r is not None:
                    return r
        return None

    for start in sorted(adj):
        r = dfs([start], {start})
        if r is not None:
            return r
    return None


def _prep_circuit(qc: Circuit, lower: bool,
                  device_model: Optional[DeviceModel] = None) -> Circuit:
    """Basis lowering + (optionally) coupling-map routing (h13 parity).

    ``lower`` runs the structural transpile to the IBM basis
    {cx, id, rz, sx, x} — the reference encodes gate counts / angle bins
    of the TRANSPILED circuit, so faithful feature distributions require
    lowered circuits.

    Passing ``device_model`` also routes onto its coupling map from a
    simple-path initial layout (the physical-qubit width grows to the
    device's). Per-edge noise channels attach to calibrated directed pairs
    only, so an unrouted ``cx`` on a non-edge would evolve noiselessly.
    Callers then read logical observables through
    ``metadata["final_layout"]``.
    """
    if not lower:
        return qc
    if device_model is None:
        return transpile(qc)
    lay = _path_layout(device_model, qc.num_qubits)
    return transpile(qc, coupling_map=list(device_model.coupling_map),
                     initial_layout=lay, num_qubits=device_model.num_qubits)


def _select_logical(vals: np.ndarray, circuits: Sequence[Circuit],
                    nq_logical: int) -> np.ndarray:
    """[B, n_phys] per-physical-qubit values → [B, nq_logical] via each
    routed circuit's final layout (identity for unrouted circuits)."""
    out = np.empty((vals.shape[0], nq_logical), vals.dtype)
    for b, qc in enumerate(circuits):
        lay = qc.metadata.get("final_layout",
                              list(range(nq_logical)))[:nq_logical]
        out[b] = vals[b, lay]
    return out


def ising_dataset(device_model: DeviceModel,
                  options: Optional[IsingOptions] = None,
                  num_circuits: int = 100,
                  steps_range: Tuple[int, int] = (0, 6),
                  J_range: Tuple[float, float] = (0.05, 0.6),
                  bases: Sequence[str] = ("Z",),
                  noise: str = "device",
                  shots: Optional[int] = 10000,
                  init_prefix: bool = False,
                  lower: bool = False,
                  route: bool = False,
                  ideal_shots: Optional[int] = None,
                  seed: int = 0,
                  device: Device = "cuda") -> LabeledDataset:
    """TFIM Trotter dataset with randomized (J, steps, basis).

    ``init_prefix`` prepends the paper's fixed random 4q initial block
    (:func:`~..circuits.families.ising_init_prefix_4q`); ``lower``
    transpiles to the IBM basis before labeling/encoding — together these
    reproduce the ``ising_init_from_qasm_*`` dataset protocol
    (``h13_ising_data_gen.ipynb`` cells 9-12).
    """
    rng = np.random.default_rng(seed)
    base = options or IsingOptions.config_4q_paper()
    nm = noise_setting(device_model, noise, seed=seed)
    init = ising_init_prefix_4q() if init_prefix else None
    circuits, meta = [], []
    for _ in range(num_circuits):
        J = float(rng.uniform(*J_range))
        steps = int(rng.integers(steps_range[0], steps_range[1]))
        basis = str(rng.choice(list(bases)))
        ops = dataclasses.replace(base, J=J)
        qc = IsingModel.make_circs_sweep(ops, steps, basis, measure=False,
                                         init=init)
        circuits.append(_prep_circuit(qc, lower,
                                      device_model if route else None))
        meta.append({"J": J, "steps": steps, "basis": basis})
    ideal, noisy = _zq_labels(circuits, device_model, nm, shots, seed,
                              ideal_shots=ideal_shots, device=device)
    if route:
        ideal = _select_logical(ideal, circuits, base.nq)
        noisy = _select_logical(noisy, circuits, base.nq)
    return LabeledDataset(circuits, ideal, noisy, meta)


def ising_step_sweep(device_model: DeviceModel, options: IsingOptions,
                     num_steps: int, basis: str = "Z",
                     noise: str = "device",
                     shots: Optional[int] = 10000,
                     init_prefix: bool = False,
                     lower: bool = False,
                     route: bool = False,
                     ideal_shots: Optional[int] = None,
                     seed: int = 0,
                     device: Device = "cuda") -> LabeledDataset:
    """Trotter-step time series (the demo2 evaluation axis)."""
    nm = noise_setting(device_model, noise, seed=seed)
    init = ising_init_prefix_4q() if init_prefix else None
    circuits = [_prep_circuit(
        IsingModel.make_circs_sweep(options, s, basis, measure=False,
                                    init=init), lower,
        device_model if route else None)
        for s in range(num_steps + 1)]
    meta = [{"J": options.J, "steps": s, "basis": basis}
            for s in range(num_steps + 1)]
    ideal, noisy = _zq_labels(circuits, device_model, nm, shots, seed,
                              ideal_shots=ideal_shots, device=device)
    if route:
        ideal = _select_logical(ideal, circuits, options.nq)
        noisy = _select_logical(noisy, circuits, options.nq)
    return LabeledDataset(circuits, ideal, noisy, meta)


def mbl_dataset(device_model: DeviceModel, num_qubits: int = 4,
                num_circuits: int = 50, theta: float = 0.05 * np.pi,
                steps_range: Tuple[int, int] = (1, 4),
                noise: str = "device",
                shots: Optional[int] = 10000,
                seed: int = 0,
                broken_connections: Optional[Sequence] = None,
                device: Device = "cuda") -> LabeledDataset:
    """MBL Floquet dataset (+ optional cut bonds for the h06 variant).

    Imbalance targets can be computed from the labels via
    :func:`dataset_imbalance`.
    """
    rng = np.random.default_rng(seed)
    nm = noise_setting(device_model, noise, seed=seed)
    circuits, meta = [], []
    for _ in range(num_circuits):
        disorder = generate_disorder(num_qubits,
                                     seed=int(rng.integers(2 ** 31)))
        steps = int(rng.integers(steps_range[0], steps_range[1] + 1))
        if broken_connections is not None:
            qc = construct_mbl_circ_with_cut(num_qubits, disorder, theta,
                                             steps, broken_connections,
                                             measure=False)
        else:
            qc = construct_mbl_circuit(num_qubits, disorder, theta, steps,
                                       measure=False)
        circuits.append(qc)
        meta.append({"disorder": disorder, "theta": theta, "steps": steps})
    ideal, noisy = _zq_labels(circuits, device_model, nm, shots, seed,
                              device=device)
    return LabeledDataset(circuits, ideal, noisy, meta)


def dataset_imbalance(ds: LabeledDataset) -> Tuple[np.ndarray, np.ndarray]:
    """(ideal, noisy) MBL charge imbalance per circuit.

    Uses the reference's counts-convention z (P(1)−P(0) = −⟨Z⟩), matching
    ``calc_imbalance``'s expectations (``mbd_utils.py:353-383``)."""
    nq = ds.ideal.shape[1]
    even = [q for q in range(nq) if q % 2 == 0]
    odd = [q for q in range(nq) if q % 2 == 1]
    return (calc_imbalance(-ds.ideal, even, odd),
            calc_imbalance(-ds.noisy, even, odd))


def tiling_dataset(device_model: DeviceModel, active_qubits: int,
                   total_qubits: int, num_circuits: int = 50,
                   theta: float = 0.05 * np.pi, steps: int = 2,
                   noise: str = "device", shots: Optional[int] = 10000,
                   seed: int = 0, device: Device = "cuda") -> LabeledDataset:
    """Small MBL circuits embedded in a larger register (``h05``)."""
    rng = np.random.default_rng(seed)
    nm = noise_setting(device_model, noise, seed=seed)
    circuits, meta = [], []
    for _ in range(num_circuits):
        disorder = generate_disorder(active_qubits,
                                     seed=int(rng.integers(2 ** 31)))
        active = construct_mbl_circuit(active_qubits, disorder, theta,
                                       steps, measure=False)
        offset = int(rng.integers(0, total_qubits - active_qubits + 1))
        qc = construct_tiling(active, total_qubits, offset, measure=False)
        circuits.append(qc)
        meta.append({"offset": offset, "steps": steps})
    ideal, noisy = _zq_labels(circuits, device_model, nm, shots, seed,
                              device=device)
    return LabeledDataset(circuits, ideal, noisy, meta)


def random_circuit_dataset(device_model: DeviceModel, num_qubits: int,
                           depth: int, num_circuits: int = 100,
                           noise: str = "device",
                           shots: Optional[int] = 10000,
                           seed: int = 0,
                           device: Device = "cuda") -> LabeledDataset:
    """Random-circuit dataset (``h38`` / ``02_data_generation``)."""
    rng = np.random.default_rng(seed)
    nm = noise_setting(device_model, noise, seed=seed)
    circuits = [random_circuit(num_qubits,
                               int(rng.integers(1, depth + 1)),
                               seed=int(rng.integers(2 ** 31)))
                for _ in range(num_circuits)]
    meta = [{"depth": c.depth()} for c in circuits]
    ideal, noisy = _zq_labels(circuits, device_model, nm, shots, seed,
                              device=device)
    return LabeledDataset(circuits, ideal, noisy, meta)
