"""Dataset generators: labeled (noisy, ideal) expectation-value samples.

Counterpart of ``mlqem_tpu/data/generators.py``, on the port's Estimators
(``primitives/estimator.py``), which run on ``device``:

* :class:`ExpValueEntry` — the canonical sample schema
  (``exp_val.py:31-89``): circuit graph, encoded observable, ideal expval,
  noisy expvals, depth; JSON round-trip compatible with reference datasets.
* :func:`exp_value_generator` — random-circuit entry stream
  (``exp_val.py:92-138``), backed by the batched engines instead of
  per-circuit Aer calls.
* :func:`generate_exp_val_dataset` — the bulk path: one statevector batch
  + one density-matrix batch for all circuits.
* :func:`rb_generator` — randomized-benchmarking entries
  (``rb.py:45-96``); 1q sequences use exact group inversion. Multi-qubit
  sequences need the stabilizer tableau (``ops/stabilizer.py``), which the
  port does not have yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, \
    Union

import numpy as np
import torch

from ..circuits.circuit import Circuit
from ..circuits.families import random_circuit
from ..circuits.observables import PauliSum, random_pauli_sum
from ..device.model import DeviceModel
from ..device.noise import NoiseModel
from ..primitives.estimator import IdealEstimator, NoisyEstimator
from ..transpile.lower import transpile
from .encoders import encode_pauli_sum_op
from .graph import circuit_to_graph_data_json, graph_to_arrays


@dataclasses.dataclass
class ExpValueEntry:
    """Canonical dataset sample (``exp_val.py:31-89`` schema parity)."""

    circuit_graph: Dict[str, Any]
    observable: List[List[float]]
    ideal_exp_value: float
    noisy_exp_values: List[float]
    circuit_depth: int = 0
    circuit: Optional[dict] = None
    metadata: Optional[dict] = None

    def __repr__(self):
        return (f"<ExpValueEntry (ideal: {self.ideal_exp_value}, "
                f"noisy: {self.noisy_exp_values})>")

    def to_dict(self) -> dict:
        return {
            "circuit_graph": self.circuit_graph,
            "observable": self.observable,
            "ideal_exp_value": self.ideal_exp_value,
            "noisy_exp_values": self.noisy_exp_values,
            "circuit_depth": self.circuit_depth,
        }

    @classmethod
    def from_json(cls, d: dict) -> "ExpValueEntry":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def to_arrays(self, max_nodes: int, max_edges: int):
        """Padded-array view (the PyG ``Data`` equivalent)."""
        x, ei, nm, em = graph_to_arrays(self.circuit_graph, max_nodes,
                                        max_edges)
        return {
            "x": x, "edge_index": ei, "node_mask": nm, "edge_mask": em,
            "y": np.float32(self.ideal_exp_value),
            "observable": np.asarray(self.observable, dtype=np.float32),
            "circuit_depth": np.float32(self.circuit_depth),
            "noisy": np.asarray(self.noisy_exp_values, dtype=np.float32),
        }


def generate_exp_val_dataset(
        device_model: DeviceModel,
        n_qubits: int,
        circuit_depth: int,
        pauli_terms: int = 1,
        pauli_coeff: float = 1.0,
        num_entries: int = 100,
        shots: Optional[int] = None,
        seed: int = 0,
        noise_model: Optional[NoiseModel] = None,
        use_features: bool = True,
        device: Union[str, torch.device] = "cuda") -> List[ExpValueEntry]:
    """Bulk dataset generation.

    All circuits are generated, transpiled, and stacked host-side, then
    labeled with ONE batched ideal run + ONE batched noisy run on
    ``device`` — replacing the reference's per-circuit Aer estimator calls
    inside a Python loop (``exp_val.py:115-138``). The host draws (circuits,
    observables, the noisy estimator's seed) follow the JAX package's, so
    the same ``seed`` gives the same circuits and observables.
    """
    rng = np.random.default_rng(seed)
    props = device_model.properties()
    # restrict the coupling map to the circuit's qubit range (identity layout
    # onto the device's first n qubits)
    sub_coupling = [(a, b) for a, b in device_model.coupling_map
                    if a < n_qubits and b < n_qubits]
    circuits, observables, depths = [], [], []
    for _ in range(num_entries):
        depth = int(rng.integers(1, circuit_depth + 1))
        qc = random_circuit(n_qubits, depth,
                            seed=int(rng.integers(2 ** 31)))
        qc = transpile(qc, basis=device_model.basis_gates,
                       coupling_map=sub_coupling or None)
        obs = random_pauli_sum(n_qubits, pauli_terms, pauli_coeff,
                               seed=int(rng.integers(2 ** 31)))
        circuits.append(qc)
        observables.append(obs)
        depths.append(qc.depth())

    ideal = IdealEstimator(device=device).run(
        circuits, observables).result().values
    noisy_est = NoisyEstimator(noise_model if noise_model is not None
                               else device_model, shots=shots,
                               seed=int(rng.integers(2 ** 31)),
                               device=device)
    noisy = noisy_est.run(circuits, observables).result().values

    entries = []
    for qc, obs, iv, nv, d in zip(circuits, observables, ideal, noisy,
                                  depths):
        graph = circuit_to_graph_data_json(
            qc, props, use_gate_features=use_features,
            use_qubit_features=use_features)
        entries.append(ExpValueEntry(
            circuit_graph=graph,
            observable=encode_pauli_sum_op(obs),
            ideal_exp_value=float(iv),
            noisy_exp_values=[float(nv)],
            circuit_depth=int(d),
            circuit=qc.to_dict(),
        ))
    return entries


def exp_value_generator(device_model: DeviceModel, n_qubits: int,
                        circuit_depth: int, pauli_terms: int,
                        pauli_coeff: float = 1.0,
                        max_entries: int = 1000,
                        seed: int = 0,
                        batch_size: int = 64,
                        device: Union[str, torch.device] = "cuda"
                        ) -> Iterator[ExpValueEntry]:
    """Streaming generator (``exp_value_generator`` API parity,
    ``exp_val.py:92-138``) — internally batched."""
    produced = 0
    batch_idx = 0
    while produced < max_entries:
        n = min(batch_size, max_entries - produced)
        for e in generate_exp_val_dataset(
                device_model, n_qubits, circuit_depth, pauli_terms,
                pauli_coeff, num_entries=n, seed=seed + batch_idx,
                device=device):
            yield e
            produced += 1
        batch_idx += 1


# ---------------------------------------------------------------------------
# Randomized benchmarking
# ---------------------------------------------------------------------------
_CLIFFORD_1Q_TABLE: Optional[List[Tuple[np.ndarray, List[str]]]] = None


def _build_clifford_1q_table():
    """Enumerate the 24 single-qubit Cliffords with shortest {h, s} words."""
    from ..circuits.gates import gate_unitary

    def canon(u):
        # strip global phase: make first nonzero entry real positive;
        # +0.0 normalizes negative zeros so tobytes() keys are stable
        flat = u.reshape(-1)
        k = np.argmax(np.abs(flat) > 1e-8)
        ph = flat[k] / abs(flat[k])
        return np.round(u / ph, 8) + (0.0 + 0.0j)

    gens = {"h": gate_unitary("h"), "s": gate_unitary("s")}
    table: Dict[bytes, Tuple[np.ndarray, List[str]]] = {}
    frontier = [(np.eye(2, dtype=np.complex128), [])]
    table[canon(np.eye(2)).tobytes()] = (np.eye(2, dtype=np.complex128), [])
    while frontier and len(table) < 24:
        nxt = []
        for u, word in frontier:
            for gname, g in gens.items():
                v = g @ u
                key = canon(v).tobytes()
                if key not in table:
                    table[key] = (v, word + [gname])
                    nxt.append((v, word + [gname]))
        frontier = nxt
    return list(table.values())


def _clifford_1q_table():
    global _CLIFFORD_1Q_TABLE
    if _CLIFFORD_1Q_TABLE is None:
        _CLIFFORD_1Q_TABLE = _build_clifford_1q_table()
    return _CLIFFORD_1Q_TABLE


def generate_rb_circuit(num_qubits: int, length: int,
                        seed: Optional[int] = None) -> Circuit:
    """A randomized-benchmarking sequence composing to the identity
    (``rb.py:20-42`` ``generate_rb_circuit`` behavioral parity).

    1q: `length` uniform random Cliffords + the single exact inverse element.
    Multi-qubit: `length` random Clifford layers, then their inverse
    (``ops/stabilizer.py::clifford_inverse_circuit``).
    """
    rng = np.random.default_rng(seed)
    if num_qubits != 1:
        from ..circuits.families import random_clifford_circuit
        from ..ops.stabilizer import clifford_inverse_circuit

        body = Circuit(num_qubits)
        for _ in range(length):
            body = body.compose(random_clifford_circuit(
                num_qubits, 1, seed=int(rng.integers(2 ** 31))))
        qc = Circuit(num_qubits).compose(body).compose(
            clifford_inverse_circuit(body))
        qc.measure_all()
        return qc
    table = _clifford_1q_table()

    def canon_key(u):
        flat = u.reshape(-1)
        k = np.argmax(np.abs(flat) > 1e-8)
        v = np.round(u / (flat[k] / abs(flat[k])), 8) + (0.0 + 0.0j)
        return v.tobytes()

    index = {canon_key(u): i for i, (u, _) in enumerate(table)}
    total = np.eye(2, dtype=np.complex128)
    qc = Circuit(1)
    for _ in range(length):
        i = int(rng.integers(24))
        u, word = table[i]
        for g in word:
            qc.append(g, (0,))
        if not word:
            qc.id(0)
        total = u @ total
    inv_idx = index[canon_key(np.conj(total.T))]
    for g in table[inv_idx][1]:
        qc.append(g, (0,))
    qc.measure_all()
    return qc


def rb_generator(device_model: DeviceModel, qubits: Sequence[int] = (0,),
                 lengths: Sequence[int] = (10,),
                 num_samples: int = 10,
                 seed: int = 0,
                 shots: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda"
                 ) -> Iterator[Tuple[ExpValueEntry, Circuit, PauliSum]]:
    """RB dataset stream (``rb.py:45-96`` parity): yields
    (entry, circuit, observable) with random Pauli-sum observables."""
    rng = np.random.default_rng(seed)
    props = device_model.properties()
    nq = len(qubits)
    for length in lengths:
        circs, obss = [], []
        for _ in range(num_samples):
            rb = generate_rb_circuit(nq, length,
                                     seed=int(rng.integers(2 ** 31)))
            qc = transpile(rb, basis=device_model.basis_gates,
                           coupling_map=device_model.coupling_map,
                           initial_layout=list(qubits),
                           num_qubits=device_model.num_qubits)
            circs.append(qc)
            obss.append(random_pauli_sum(device_model.num_qubits, 1, 1.0,
                                         seed=int(rng.integers(2 ** 31))))
        ideal = IdealEstimator(device=device).run(circs, obss
                                                  ).result().values
        noisy = NoisyEstimator(device_model, shots=shots,
                               seed=int(rng.integers(2 ** 31)),
                               device=device).run(circs, obss).result().values
        for qc, obs, iv, nv in zip(circs, obss, ideal, noisy):
            graph = circuit_to_graph_data_json(qc, props,
                                               use_gate_features=True,
                                               use_qubit_features=True)
            entry = ExpValueEntry(
                circuit_graph=graph,
                observable=encode_pauli_sum_op(obs),
                ideal_exp_value=float(iv),
                noisy_exp_values=[float(nv)],
                circuit_depth=int(qc.depth()),
            )
            yield entry, qc, obs
