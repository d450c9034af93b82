"""Estimator primitives: the framework's execution API, in torch.

Counterpart of ``mlqem_tpu/primitives/estimator.py``: the qiskit
Estimator-primitive surface, ``estimator.run(circuits, observables,
parameter_values) → job`` with ``job.result().values``.

Backends:
* :class:`IdealEstimator`: exact statevector expectation values.
* :class:`NoisyEstimator`: density matrices under a device noise model,
  optional readout error and shot sampling.
* :class:`CountsBackend`: counts dicts (``execute → get_counts`` parity).

Each takes the torch ``device`` it runs on (the card unless the caller asks
for the CPU) and, where it samples, a ``seed`` for one ``torch.Generator``
that serves every later call (the JAX package splits a key per call).
"""
from __future__ import annotations

import dataclasses
import uuid
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..circuits.circuit import Circuit, stack_circuits
from ..circuits.observables import PauliSum, PauliTerm
from ..circuits.parameters import bind_parameters, circuit_parameters
from ..device.model import DeviceModel
from ..device.noise import NoiseModel, compile_noise_table
from ..ops.density import (apply_readout_confusion, batch_density_matrices,
                           batch_density_matrices_from, dm_probabilities,
                           expval_pauli_sum_dm)
from ..ops.sampling import histogram_to_counts, sample_histogram, \
    sample_outcomes
from ..ops.statevector import batch_statevectors, expval_pauli_sum


@dataclasses.dataclass
class EstimatorResult:
    """values[i] = ⟨observables[i]⟩ for circuits[i]; metadata per item."""

    values: np.ndarray
    metadata: List[dict]


class Job:
    """Synchronous job wrapper (parity with the JobV1 surface the
    reference's ``PostProcessedJob`` wraps, ``learning/estimator.py:197``)."""

    def __init__(self, result: EstimatorResult, job_id: Optional[str] = None):
        self._result = result
        self._job_id = job_id or str(uuid.uuid4())

    def result(self) -> EstimatorResult:
        return self._result

    def job_id(self) -> str:
        return self._job_id

    def status(self) -> str:
        return "DONE"

    def cancel(self):
        return None


def _normalize_run_args(circuits, observables, parameter_values):
    if isinstance(circuits, Circuit):
        circuits = [circuits]
    if isinstance(observables, (PauliSum, str)):
        observables = [observables] * len(circuits)
    observables = [PauliSum(o) if isinstance(o, str) else o
                   for o in observables]
    if parameter_values is None:
        parameter_values = [()] * len(circuits)
    elif parameter_values and np.isscalar(parameter_values[0]):
        parameter_values = [parameter_values]
    if not (len(circuits) == len(observables) == len(parameter_values)):
        raise ValueError(
            f"length mismatch: {len(circuits)} circuits, "
            f"{len(observables)} observables, "
            f"{len(parameter_values)} parameter sets")
    bound = []
    for qc, pv, obs in zip(circuits, parameter_values, observables):
        if obs.num_qubits != qc.num_qubits:
            raise ValueError(
                f"observable width {obs.num_qubits} != circuit width "
                f"{qc.num_qubits}")
        if circuit_parameters(qc):
            qc = bind_parameters(qc, list(pv))
        bound.append(qc)
    return bound, observables


def _noise_model(backend: Union[DeviceModel, NoiseModel, None]
                 ) -> Optional[NoiseModel]:
    if isinstance(backend, DeviceModel):
        return NoiseModel.from_device(backend)
    return backend


def _seeded(device: torch.device, seed: int) -> torch.Generator:
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return generator


def _parity(outcomes: np.ndarray, support: int) -> np.ndarray:
    """Parity of the ``support`` bits of every outcome (int64 array)."""
    par = np.zeros_like(outcomes)
    for q in range(int(support).bit_length()):
        if (support >> q) & 1:
            par ^= (outcomes >> q) & 1
    return par


class BaseEstimator:
    """Estimator base: ``run`` normalizes, ``_run`` computes (patch point)."""

    def run(self, circuits, observables, parameter_values=None,
            **run_options) -> Job:
        return self._run(circuits, observables, parameter_values,
                         **run_options)

    def _run(self, circuits, observables, parameter_values=None,
             **run_options) -> Job:
        raise NotImplementedError


class IdealEstimator(BaseEstimator):
    """Exact expectation values from the batched statevector engine."""

    def __init__(self, device: Union[str, torch.device] = "cuda"):
        self.device = torch.device(device)

    def _run(self, circuits, observables, parameter_values=None,
             **run_options) -> Job:
        circuits, observables = _normalize_run_args(
            circuits, observables, parameter_values)
        states = batch_statevectors(stack_circuits(circuits),
                                    self.device)
        values = np.empty(len(circuits), dtype=np.float64)
        for i, obs in enumerate(observables):
            values[i] = float(expval_pauli_sum(states[i], obs))
        meta = [{"simulator": "statevector", "shots": None}
                for _ in circuits]
        return Job(EstimatorResult(values, meta))


def _basis_rotation_circuit(term: PauliTerm, num_qubits: int) -> Circuit:
    """Append-able rotation mapping the term's eigenbasis to Z."""
    return _rotation_from_basis(term.codes(), num_qubits)


def _measurement_groups(terms: Sequence[PauliTerm]
                        ) -> List[Tuple[List[int], List[PauliTerm]]]:
    """Greedy qubit-wise grouping of terms into shared measurement bases.

    Two terms share a basis when every qubit on which both act non-trivially
    carries the same Pauli (qubit-wise commuting). Returns ``(basis,
    terms)`` pairs where ``basis[q] ∈ {0:free/Z, 1:X, 2:Y, 3:Z}``.
    """
    groups: List[Tuple[List[int], List[PauliTerm]]] = []
    for term in terms:
        codes = term.codes()
        placed = False
        for basis, members in groups:
            if all(c == 0 or basis[q] in (0, int(c))
                   for q, c in enumerate(codes)):
                for q, c in enumerate(codes):
                    if c != 0:
                        basis[q] = int(c)
                members.append(term)
                placed = True
                break
        if not placed:
            groups.append(([int(c) for c in codes], [term]))
    return groups


def _rotation_from_basis(basis: Sequence[int], num_qubits: int) -> Circuit:
    """Rotation circuit mapping the group's eigenbasis to Z (free/Z → id)."""
    rot = Circuit(num_qubits)
    for q, code in enumerate(basis):
        if code == 1:      # X → H
            rot.h(q)
        elif code == 2:    # Y → Sdg, H
            rot.sdg(q).h(q)
    return rot


class NoisyEstimator(BaseEstimator):
    """Density-matrix simulation under a device noise model.

    Args:
        backend: a DeviceModel (noise auto-built Aer-style, kept as
            ``device_model``) or a NoiseModel.
        shots: None → exact expectation of the noisy state; int → sampled.
        readout: include readout (assignment) error in measurement.
        seed: seed of the generator the shots are drawn from.
        device: the torch device the simulation runs on.
    """

    def __init__(self, backend: Union[DeviceModel, NoiseModel, None] = None,
                 shots: Optional[int] = None, readout: bool = True,
                 seed: int = 0, device: Union[str, torch.device] = "cuda"):
        self.noise_model = _noise_model(backend)
        self.device_model: Optional[DeviceModel] = \
            backend if isinstance(backend, DeviceModel) else None
        self.shots = shots
        self.readout = readout
        self.device = torch.device(device)
        self._generator = _seeded(self.device, seed)

    def _run(self, circuits, observables, parameter_values=None,
             **run_options) -> Job:
        shots = run_options.get("shots", self.shots)
        circuits, observables = _normalize_run_args(
            circuits, observables, parameter_values)
        n = circuits[0].num_qubits
        ct = stack_circuits(circuits)
        keys, table = compile_noise_table(ct, self.noise_model)
        dms = batch_density_matrices(ct, keys, table, self.device)

        confusion = None
        if self.readout and self.noise_model is not None \
                and self.noise_model.readout is not None:
            confusion = torch.as_tensor(
                np.asarray(self.noise_model.readout[:n], np.float32),
                device=self.device)

        exact = shots is None and confusion is None
        values = np.zeros(len(circuits), dtype=np.float64)
        # one measurement job per (circuit, qubit-wise-commuting basis
        # group); all rotation evolutions then run as one batch
        jobs: List[Tuple[int, Circuit, List[Tuple[float, int]]]] = []
        for i, obs in enumerate(observables):
            terms = list(obs.terms)
            if exact:
                # diagonal terms read the dm diagonal exactly; only X/Y
                # terms need a (noisy) basis rotation + measurement
                diag = [t for t in terms if t.masks()[0] == 0]
                terms = [t for t in terms if t.masks()[0] != 0]
                if diag:
                    values[i] += float(
                        expval_pauli_sum_dm(dms[i], PauliSum(diag)))
            for basis, members in _measurement_groups(terms):
                entries = [(float(np.real(t.coeff)),
                            t.masks()[0] | t.masks()[1]) for t in members]
                jobs.append((i, _rotation_from_basis(basis, n), entries))

        if jobs:
            rot_ct = stack_circuits([rot for _, rot, _ in jobs])
            rkeys, rtable = compile_noise_table(rot_ct, self.noise_model)
            dm0 = dms[torch.as_tensor([i for i, _, _ in jobs],
                                      device=dms.device)]
            del dms
            probs = dm_probabilities(
                batch_density_matrices_from(rot_ct, rkeys, rtable, dm0))
            if confusion is not None:
                probs = apply_readout_confusion(probs, confusion, n)
            if shots is None:
                pr = probs.cpu().numpy().astype(np.float64)
                idx = np.arange(pr.shape[-1], dtype=np.int64)
                for (i, _, entries), p in zip(jobs, pr):
                    for coeff, support in entries:
                        sign = 1.0 - 2.0 * _parity(idx, support)
                        values[i] += coeff * float(p @ sign)
            else:
                # one shot table per basis group, shared by its terms:
                # hardware measurement semantics (and one sampling call)
                outs = sample_outcomes(probs, int(shots), self._generator
                                       ).cpu().numpy().astype(np.int64)
                for (i, _, entries), o in zip(jobs, outs):
                    for coeff, support in entries:
                        par = _parity(o, support)
                        values[i] += coeff * (1.0 - 2.0 * float(np.mean(par)))
        meta = [{"simulator": "density_matrix", "shots": shots,
                 "readout": confusion is not None} for _ in circuits]
        return Job(EstimatorResult(values, meta))


class CountsBackend:
    """Counts-dict execution surface (``execute → get_counts`` parity).

    Circuits are executed under the noise model; outcomes include readout
    error; counts use qiskit bitstring format (leftmost = highest qubit).
    """

    def __init__(self, backend: Union[DeviceModel, NoiseModel, None] = None,
                 seed: int = 0, device: Union[str, torch.device] = "cuda"):
        self.noise_model = _noise_model(backend)
        self.device = torch.device(device)
        self._generator = _seeded(self.device, seed)

    def _probs(self, circuits: Sequence[Circuit]) -> torch.Tensor:
        n = circuits[0].num_qubits
        ct = stack_circuits(list(circuits))
        keys, table = compile_noise_table(ct, self.noise_model)
        probs = dm_probabilities(batch_density_matrices(
            ct, keys, table, self.device))
        if self.noise_model is not None \
                and self.noise_model.readout is not None:
            probs = apply_readout_confusion(
                probs, torch.as_tensor(np.asarray(
                    self.noise_model.readout[:n], np.float32),
                    device=self.device), n)
        return probs[:, :2 ** n]

    def run_probs(self, circuits: Sequence[Circuit]) -> np.ndarray:
        """Measurement distributions after noise + readout: [B, 2**n]."""
        return self._probs(circuits).cpu().numpy()

    def run_counts(self, circuits: Sequence[Circuit], shots: int = 10000
                   ) -> List[Dict[str, int]]:
        n = circuits[0].num_qubits
        hists = sample_histogram(self._probs(circuits), shots, 2 ** n,
                                 self._generator).cpu().numpy()
        return [histogram_to_counts(h, n) for h in hists]
