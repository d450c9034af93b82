"""Circuit families: the dataset-generation workloads.

Rebuilds every circuit family the reference experiments use (SURVEY §2.2-2.3):

* TFIM Trotter (``IsingModel`` with the paper's 4q/6q/10q/100q presets —
  ``h13_ising_data_gen.ipynb`` / ``h31_submit_zne_hardware_100q_twirl.ipynb``
  IsingModel cells)
* MBL Floquet dynamics incl. cut bonds (``mbd_utils.py:414-530``)
* brickwork random Clifford circuits (``mbd_utils.py:140-205``)
* generic random circuits (qiskit ``random_circuit`` parity as used by
  ``exp_value_generator``, ``data/generators/exp_val.py:116``)
* TwoLocal VQE ansatz (``vqe_data_gen_parallel.py:77-94``)
* tiling — small active circuit embedded in a big register
  (``h05_tiling_data_gen``)
* composed Cliffords for the 100-400q scalability sweep
  (``06_scalability.ipynb`` ``generate_composed_clifford``)

Builders emit plain :class:`Circuit` objects (host numpy, the counterpart of
``mlqem_tpu/circuits/families.py``); batches with shared topology (e.g.
Trotter step sweeps, ansatz parameter sweeps) should go through
``tensorize_template``/``stack_circuits`` so the simulators run the whole
batch at once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .circuit import Circuit
from .parameters import Parameter


# ---------------------------------------------------------------------------
# TFIM Trotter (the workhorse benchmark)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class IsingOptions:
    """TFIM Trotter options with the paper's named presets."""

    nq: int = 4
    h: float = 1.0
    J: float = 0.15
    dt: float = 0.25
    depth: int = 15
    measure_basis: str = "Z"

    @classmethod
    def config_4q_paper(cls, **kw) -> "IsingOptions":
        return cls(nq=4, h=1.0, J=0.15, dt=0.5, **kw)

    @classmethod
    def config_6q_paper(cls, **kw) -> "IsingOptions":
        return cls(nq=6, h=math.pi, J=0.15, dt=0.5, **kw)

    @classmethod
    def config_10q_paper(cls, **kw) -> "IsingOptions":
        return cls(nq=10, h=1.0, J=0.5236, dt=0.25, **kw)

    @classmethod
    def config_100q_paper_clifford(cls, **kw) -> "IsingOptions":
        return cls(nq=100, h=0.5 * math.pi, J=0.15, dt=0.5, **kw)

    @classmethod
    def config_100q_paper_nonclifford(cls, **kw) -> "IsingOptions":
        return cls(nq=100, h=0.66 * math.pi, J=0.15, dt=0.5, **kw)


def ising_init_prefix_4q() -> Circuit:
    """The paper's fixed random 4q initial-state block.

    The single-Ising datasets behind the published figure-4 RMSE table
    prepend ONE fixed random init circuit to every Trotter circuit
    (``h13_ising_data_gen.ipynb`` ``construct_ising_circuit_random_init``:
    a hard-coded qasm string — rz/rz on q1, rz+rx on q3, cx(3,0), rx on
    q2, cx(2,3)).  Train and test share it; it scrambles the domain-wall
    structure so per-qubit ⟨Z⟩ labels are not symmetric functions of the
    Trotter layer alone.
    """
    qc = Circuit(4)
    qc.rz(0.0007186381718527407, 1)
    qc.rz(2.4917901988569855, 1)
    qc.rz(3.3854853863523835, 3)
    qc.rx(1.2846113715328817, 3)
    qc.cx(3, 0)
    qc.rx(4.212671608894216, 2)
    qc.cx(2, 3)
    return qc


class IsingModel:
    """1D transverse-field Ising Trotter circuits.

    One step: RX(2·h·dt) on all qubits, then exp(-i·J·dt·ZZ) on even bonds
    (CX-RZ-CX), then on odd bonds — the reference's exact layer structure.
    """

    Options = IsingOptions

    @staticmethod
    def apply_layer(qc: Circuit, ops: IsingOptions):
        allq = list(range(ops.nq))
        J_angle = -2 * ops.J * ops.dt
        h_angle = 2 * ops.h * ops.dt
        qc.rx(h_angle, allq)
        qc.barrier()
        even = allq[0::2][: (ops.nq // 2)]
        for q0 in even:
            if q0 + 1 < ops.nq:
                qc.cx(q0, q0 + 1)
        qc.rz(J_angle, [q + 1 for q in even if q + 1 < ops.nq])
        for q0 in even:
            if q0 + 1 < ops.nq:
                qc.cx(q0, q0 + 1)
        qc.barrier()
        odd = allq[1:-2:2]
        for q0 in odd:
            qc.cx(q0, q0 + 1)
        qc.rz(J_angle, allq[2:-1:2])
        for q0 in odd:
            qc.cx(q0, q0 + 1)
        qc.barrier()

    @classmethod
    def make_circuit(cls, ops: IsingOptions, measure: bool = True,
                     init: Optional[Circuit] = None) -> Circuit:
        qc = Circuit(ops.nq)
        if init is not None:
            # fixed initial-state block BEFORE the Trotter layers
            # (h13 ``qc_init.compose(make_circs_sweep(...))``)
            qc.ops.extend(init.ops)
            qc.barrier()
        for _ in range(ops.depth):
            cls.apply_layer(qc, ops)
        allq = list(range(ops.nq))
        if ops.measure_basis == "Z":
            pass
        elif ops.measure_basis == "X":
            qc.h(allq)
        elif ops.measure_basis == "Y":
            qc.sdg(allq)
            qc.h(allq)
        else:
            raise ValueError("measure_basis must be X, Y or Z")
        if measure:
            qc.measure_all()
        qc.metadata.update(measure_basis=ops.measure_basis, depth=ops.depth,
                           J=ops.J, h=ops.h, dt=ops.dt)
        return qc

    @classmethod
    def make_circs_sweep(cls, ops: IsingOptions, num_steps: int,
                         measure_basis: str, measure: bool = True,
                         init: Optional[Circuit] = None) -> Circuit:
        ops = dataclasses.replace(ops, depth=num_steps,
                                  measure_basis=measure_basis)
        return cls.make_circuit(ops, measure=measure, init=init)


# ---------------------------------------------------------------------------
# MBL Floquet dynamics
# ---------------------------------------------------------------------------
def generate_disorder(n_qubits: int, disorder_strength: float = math.pi,
                      seed: Optional[int] = None) -> List[float]:
    rng = np.random.default_rng(seed)
    return rng.uniform(-disorder_strength, disorder_strength,
                       size=n_qubits).tolist()


def construct_mbl_circuit(num_qubit: int, disorder: Sequence[float],
                          theta: float, steps: int,
                          completely_random: bool = False,
                          seed: Optional[int] = None,
                          measure: bool = True) -> Circuit:
    """Floquet MBL circuit: CZ+U3 brickwork over a domain-wall init state.

    Parity with ``construct_mbl_circuit`` (``mbd_utils.py:414-466``):
    odd qubits start flipped; each step applies CZ+U3(θ, 0, -π) on even then
    odd bonds, then per-qubit disorder phases.
    """
    rng = np.random.default_rng(seed)

    def rand(k):
        return (8 * math.pi * rng.random(k) - 4 * math.pi).tolist()

    qc = Circuit(num_qubit)
    for q in range(num_qubit):
        if q % 2 == 1:
            qc.x(q)
    for _ in range(steps):
        for even in range(0, num_qubit - 1, 2):
            qc.cz(even, even + 1)
            if completely_random:
                qc.u3(*rand(3), even)
                qc.u3(*rand(3), even + 1)
            else:
                qc.u3(theta, 0.0, -math.pi, even)
                qc.u3(theta, 0.0, -math.pi, even + 1)
        for odd in range(1, num_qubit - 1, 2):
            qc.cz(odd, odd + 1)
            if completely_random:
                qc.u3(*rand(3), odd)
                qc.u3(*rand(3), odd + 1)
            else:
                qc.u3(theta, 0.0, -math.pi, odd)
                qc.u3(theta, 0.0, -math.pi, odd + 1)
        for q in range(num_qubit):
            qc.p(rand(1)[0] if completely_random else disorder[q], q)
    if measure:
        qc.measure_all()
    return qc


def construct_mbl_circ_with_cut(num_qubit: int, disorder: Sequence[float],
                                theta: float, steps: int,
                                broken_connections: Optional[
                                    Sequence[Tuple[int, int]]] = None,
                                measure: bool = True) -> Circuit:
    """MBL circuit with removed CZ bonds — the circuit-cutting experiment
    (``mbd_utils.py:488-530``, ``h06_circ_cut_data_gen``)."""
    broken = set(tuple(b) for b in (broken_connections or []))
    qc = Circuit(num_qubit)
    for q in range(num_qubit):
        if q % 2 == 1:
            qc.x(q)
    for _ in range(steps):
        for even in range(0, num_qubit - 1, 2):
            if (even, even + 1) not in broken:
                qc.cz(even, even + 1)
            qc.u3(theta, 0.0, -math.pi, even)
            qc.u3(theta, 0.0, -math.pi, even + 1)
        for odd in range(1, num_qubit - 1, 2):
            if (odd, odd + 1) not in broken:
                qc.cz(odd, odd + 1)
            qc.u3(theta, 0.0, -math.pi, odd)
            qc.u3(theta, 0.0, -math.pi, odd + 1)
        for q in range(num_qubit):
            qc.p(disorder[q], q)
    if measure:
        qc.measure_all()
    return qc


# ---------------------------------------------------------------------------
# Random circuits
# ---------------------------------------------------------------------------
_CLIFFORD_1Q = ["id", "x", "y", "z", "h", "s", "sdg"]
_CLIFFORD_2Q = ["cx", "cy", "cz", "swap"]


def random_clifford_circuit(num_qubits: int, depth: int,
                            max_operands: int = 2,
                            seed: Optional[int] = None) -> Circuit:
    """Brickwork random Clifford circuit (``mbd_utils.py:140-205`` parity):
    per layer, shuffle qubits, greedily assign 1q/2q Clifford gates."""
    if not 1 <= max_operands <= 2:
        raise ValueError("max_operands must be 1 or 2")
    rng = np.random.default_rng(seed)
    qc = Circuit(num_qubits)
    for _ in range(depth):
        remaining = list(range(num_qubits))
        rng.shuffle(remaining)
        while remaining:
            max_possible = min(len(remaining), max_operands)
            n_operands = int(rng.choice(range(max_possible))) + 1
            operands = [remaining.pop() for _ in range(n_operands)]
            if n_operands == 1:
                qc.append(str(rng.choice(_CLIFFORD_1Q)), operands)
            else:
                qc.append(str(rng.choice(_CLIFFORD_2Q)), operands)
    return qc


_RANDOM_1Q = ["id", "x", "y", "z", "h", "s", "sdg", "t", "tdg",
              "rx", "ry", "rz", "p", "u2", "u3"]
_RANDOM_2Q = ["cx", "cy", "cz", "ch", "crz", "cp", "swap", "rzz"]


def random_circuit(num_qubits: int, depth: int, max_operands: int = 2,
                   measure: bool = False,
                   seed: Optional[int] = None) -> Circuit:
    """Generic random circuit (qiskit ``random_circuit`` behavioral parity:
    same gate pool and layer-filling strategy)."""
    from .gates import GATE_NUM_PARAMS

    rng = np.random.default_rng(seed)
    qc = Circuit(num_qubits)
    for _ in range(depth):
        remaining = list(range(num_qubits))
        rng.shuffle(remaining)
        while remaining:
            max_possible = min(len(remaining), max_operands)
            n_operands = int(rng.choice(range(max_possible))) + 1
            operands = [remaining.pop() for _ in range(n_operands)]
            pool = _RANDOM_1Q if n_operands == 1 else _RANDOM_2Q
            name = str(rng.choice(pool))
            n_par = GATE_NUM_PARAMS[name]
            params = rng.uniform(0, 2 * math.pi, size=n_par).tolist()
            qc.append(name, operands, params)
    if measure:
        qc.measure_all()
    return qc


# ---------------------------------------------------------------------------
# VQE ansatz
# ---------------------------------------------------------------------------
def two_local_ansatz(num_qubits: int, reps: int = 3,
                     rotation: str = "ry", entangler: str = "cz",
                     entanglement: str = "full",
                     parameter_prefix: str = "θ") -> Circuit:
    """TwoLocal(ry, cz, reps) parity (``vqe_data_gen_parallel.py:77-94``,
    ``vqe_rf.py:243``): rotation layer, entangling layer, × reps, plus a
    final rotation layer. Returns a parameterized circuit."""
    qc = Circuit(num_qubits)
    k = 0

    def rot_layer():
        nonlocal k
        for q in range(num_qubits):
            qc.append(rotation, (q,), (Parameter(f"{parameter_prefix}[{k}]"),))
            k += 1

    def ent_layer():
        if entanglement == "full":
            pairs = [(a, b) for a in range(num_qubits)
                     for b in range(a + 1, num_qubits)]
        elif entanglement == "linear":
            pairs = [(q, q + 1) for q in range(num_qubits - 1)]
        else:
            raise ValueError(f"unknown entanglement {entanglement!r}")
        for a, b in pairs:
            qc.append(entangler, (a, b))

    for _ in range(reps):
        rot_layer()
        ent_layer()
    rot_layer()
    return qc


# ---------------------------------------------------------------------------
# Scaling tricks: tiling + composed Cliffords
# ---------------------------------------------------------------------------
def construct_tiling(active: Circuit, num_total_qubits: int,
                     offset: int = 0, measure: bool = True) -> Circuit:
    """Embed a k-qubit active circuit into an n-qubit register, other qubits
    idle (``h05_tiling_data_gen`` ``construct_tiling`` behavior)."""
    if offset + active.num_qubits > num_total_qubits:
        raise ValueError("active circuit does not fit at this offset")
    from .circuit import Op
    from .gates import is_structural

    qc = Circuit(num_total_qubits, dict(active.metadata))
    for op in active.ops:
        if is_structural(op.name):
            continue
        qc.ops.append(Op(op.name, tuple(q + offset for q in op.qubits),
                         op.params))
    if measure:
        qc.measure_all()
    return qc


def generate_composed_clifford(block_qubits: int, num_blocks: int,
                               depth: int, seed: Optional[int] = None,
                               measure: bool = False) -> Circuit:
    """Stitch independent k-qubit Clifford blocks into one wide circuit
    (``06_scalability.ipynb`` ``generate_composed_clifford``: 20q blocks →
    100-400q circuits for the stabilizer-method sweep)."""
    rng = np.random.default_rng(seed)
    total = block_qubits * num_blocks
    from .circuit import Op

    qc = Circuit(total)
    for b in range(num_blocks):
        block = random_clifford_circuit(block_qubits, depth,
                                        seed=int(rng.integers(2 ** 31)))
        off = b * block_qubits
        for op in block.ops:
            qc.ops.append(Op(op.name, tuple(q + off for q in op.qubits),
                             op.params))
    if measure:
        qc.measure_all()
    return qc
