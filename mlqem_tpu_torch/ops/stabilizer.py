"""Stabilizer-tableau simulator (Aaronson–Gottesman CHP).

Counterpart of ``mlqem_tpu/ops/stabilizer.py``: replaces
``AerSimulator(method='stabilizer')`` for the 100-400q Clifford
scalability sweep (``06_scalability.ipynb``) and gives the analytic
Clifford labels of ``force_nonzero_expectation``
(``docs/tutorials/mbd_utils.py:208-311``).

The tableau is JAX's layout: bool ``x, z[B, 2n, n]`` plus sign bits
``r[B, 2n]`` (rows 0..n-1 destabilizers, n..2n-1 stabilizers), batched
over circuits. Circuits are decomposed on the host into the {H, S, CX}
primitive stream; the host then packs each stream into layers of
primitives on disjoint qubits (each primitive in the first layer after
the last one that touched its qubits; streams padded with NOP), and one
layer is one set of masked column updates for every circuit at once.
Primitives on disjoint qubits commute, and each one's sign update reads
only its own columns, so a layer gives the tableau the stream gives.
Pauli expectation values are computed in-tableau (0 / ±1, exact).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..circuits.circuit import Circuit
from ..circuits.gates import is_structural
from ..circuits.observables import PauliSum

Device = Union[str, torch.device]

# ---------------------------------------------------------------------------
# Host-side decomposition of Clifford gates into {H, S, CX}
# ---------------------------------------------------------------------------
_PRIM_H, _PRIM_S, _PRIM_CX, _PRIM_NOP = 0, 1, 2, 3

# gate → list of (prim, which_operand(s)) templates; operands refer to the
# op's qubit slots (0 = first, 1 = second)
_CLIFFORD_DECOMP = {
    "id": [],
    "h": [("h", 0)],
    "s": [("s", 0)],
    "sdg": [("s", 0), ("s", 0), ("s", 0)],
    "z": [("s", 0), ("s", 0)],
    "x": [("h", 0), ("s", 0), ("s", 0), ("h", 0)],
    "y": [("s", 0), ("s", 0), ("h", 0), ("s", 0), ("s", 0), ("h", 0)],
    "sx": [("h", 0), ("s", 0), ("h", 0)],
    "sxdg": [("h", 0), ("s", 0), ("s", 0), ("s", 0), ("h", 0)],
    "cx": [("cx", (0, 1))],
    "cz": [("h", 1), ("cx", (0, 1)), ("h", 1)],
    "cy": [("s", 1), ("s", 1), ("s", 1), ("cx", (0, 1)), ("s", 1)],
    "swap": [("cx", (0, 1)), ("cx", (1, 0)), ("cx", (0, 1))],
    # ecr = sdg(a)·sxdg(b)·cx(a,b)·x(a) as an op sequence (x first)
    "ecr": [("h", 0), ("s", 0), ("s", 0), ("h", 0),          # x(a)
            ("cx", (0, 1)),
            ("s", 0), ("s", 0), ("s", 0),                     # sdg(a)
            ("h", 1), ("s", 1), ("s", 1), ("s", 1), ("h", 1)  # sxdg(b)
            ],
}

CLIFFORD_GATES = frozenset(_CLIFFORD_DECOMP)


def _try_angle_decomp(name: str, params) -> Optional[List]:
    """Decompose rz/p/rx/ry at multiples of π/2 into Clifford primitives
    (so Trotter circuits at Clifford parameter points run at 100q+)."""
    if name not in ("rz", "p", "rx", "ry"):
        return None
    t = float(params[0])
    k = round(t / (np.pi / 2))
    if abs(t - k * np.pi / 2) > 1e-7:
        return None
    k %= 4
    s_seq = [("s", 0)] * k                      # p(kπ/2) = S^k
    if name in ("p", "rz"):                     # rz = p up to global phase
        return s_seq
    if name == "rx":                            # rx(θ) = h rz(θ) h
        return [("h", 0)] + s_seq + [("h", 0)]
    # ry(θ) = sdg · rx(θ) · s  (up to global phase)
    sdg = [("s", 0)] * 3
    return sdg + [("h", 0)] + s_seq + [("h", 0), ("s", 0)]


def decompose_to_primitives(circuit: Circuit) -> Tuple[np.ndarray, np.ndarray]:
    """Circuit → (prim_types[L], prim_qubits[L, 2]) in {H, S, CX}."""
    types: List[int] = []
    qubits: List[Tuple[int, int]] = []
    kinds = {"h": _PRIM_H, "s": _PRIM_S, "cx": _PRIM_CX}

    for op in circuit.ops:
        if is_structural(op.name):
            continue
        decomp = _CLIFFORD_DECOMP.get(op.name)
        if decomp is None:
            decomp = _try_angle_decomp(op.name, op.params)
        if decomp is None:
            raise ValueError(
                f"{op.name}{op.params} is not a Clifford operation")
        for kind, slots in decomp:
            types.append(kinds[kind])
            if kind == "cx":
                qubits.append((op.qubits[slots[0]], op.qubits[slots[1]]))
            else:
                qubits.append((op.qubits[slots], 0))
    if not types:
        types, qubits = [_PRIM_NOP], [(0, 0)]
    return (np.asarray(types, np.int32), np.asarray(qubits, np.int32))


# ---------------------------------------------------------------------------
# Tableau evolution
# ---------------------------------------------------------------------------
def zero_tableau(n: int, batch: Sequence[int] = (), device: Device = "cuda"
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """|0…0⟩ tableau: destabilizers X_i, stabilizers Z_i."""
    eye = torch.eye(n, dtype=torch.bool, device=device)
    zero = torch.zeros((n, n), dtype=torch.bool, device=device)
    x = torch.cat([eye, zero]).expand(*batch, 2 * n, n).clone()
    z = torch.cat([zero, eye]).expand(*batch, 2 * n, n).clone()
    r = torch.zeros((*batch, 2 * n), dtype=torch.bool, device=device)
    return x, z, r


def _layers(types: np.ndarray, qubits: np.ndarray, n: int
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack [B, L] primitive streams into layers of primitives on disjoint
    qubits, each primitive in the first layer after the last one that
    touched its qubits: (kind, q0, q1) [n_layers, B, P], padded with NOP.
    A 1q primitive's second operand, and both of a NOP's, are the scratch
    column n."""
    B = types.shape[0]
    per_circuit = []
    for b in range(B):
        ready = np.zeros(n, np.int64)
        layers: List[List[Tuple[int, int, int]]] = []
        for kind, (q0, q1) in zip(types[b].tolist(), qubits[b].tolist()):
            if kind == _PRIM_NOP:
                continue
            qs = (q0, q1) if kind == _PRIM_CX else (q0,)
            li = int(max(ready[q] for q in qs))
            for q in qs:
                ready[q] = li + 1
            if li == len(layers):
                layers.append([])
            layers[li].append((kind, q0, q1 if kind == _PRIM_CX else n))
        per_circuit.append(layers)
    n_layers = max(1, max(len(c) for c in per_circuit))
    width = max([1] + [len(layer) for c in per_circuit for layer in c])
    kind = np.full((n_layers, B, width), _PRIM_NOP, np.int64)
    q0 = np.full((n_layers, B, width), n, np.int64)
    q1 = np.full((n_layers, B, width), n, np.int64)
    for b, layers in enumerate(per_circuit):
        for li, layer in enumerate(layers):
            arr = np.asarray(layer, np.int64)
            kind[li, b, :len(layer)] = arr[:, 0]
            q0[li, b, :len(layer)] = arr[:, 1]
            q1[li, b, :len(layer)] = arr[:, 2]
    return kind, q0, q1


def run_tableau(prim_types, prim_qubits, n: int, device: Device = "cuda"
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Evolve the |0…0⟩ tableau through primitive streams.

    ``prim_types`` [L] or [B, L] (``_PRIM_NOP`` pads), ``prim_qubits``
    [L, 2] or [B, L, 2], on the host. Returns (x, z, r) on ``device``,
    [2n, n]/[2n] or batched [B, 2n, n]/[B, 2n].
    """
    types = np.asarray(prim_types, np.int64)
    qubits = np.asarray(prim_qubits, np.int64)
    single = types.ndim == 1
    if single:
        types, qubits = types[None], qubits[None]
    B = types.shape[0]
    kinds, q0s, q1s = (torch.as_tensor(a, device=device)
                       for a in _layers(types, qubits, n))
    x, z, r = zero_tableau(n, (B,), device)
    # one scratch column (index n) takes the writes of padding and of the
    # second operand of 1q primitives
    pad = torch.zeros((B, 2 * n, 1), dtype=torch.bool, device=device)
    x, z = torch.cat([x, pad], dim=2), torch.cat([z, pad], dim=2)
    for kind, q0, q1 in zip(kinds, q0s, q1s):
        i0 = q0[:, None, :].expand(B, 2 * n, q0.shape[-1])
        i1 = q1[:, None, :].expand(B, 2 * n, q1.shape[-1])
        xa, za = x.gather(2, i0), z.gather(2, i0)
        xb, zb = x.gather(2, i1), z.gather(2, i1)
        is_h, is_s, is_cx = ((kind == k)[:, None, :]
                             for k in (_PRIM_H, _PRIM_S, _PRIM_CX))
        flip = torch.where(is_h | is_s, xa & za,
                           is_cx & xa & zb & ~(xb ^ za))
        x_a = torch.where(is_h, za, xa)
        z_a = torch.where(is_h, xa, torch.where(
            is_s, za ^ xa, torch.where(is_cx, za ^ zb, za)))
        x_b = torch.where(is_cx, xb ^ xa, xb)
        r = r ^ (flip.sum(-1) % 2).bool()
        x.scatter_(2, i0, x_a)
        z.scatter_(2, i0, z_a)
        x.scatter_(2, i1, x_b)
    x, z = x[..., :n].contiguous(), z[..., :n].contiguous()
    if single:
        return x[0], z[0], r[0]
    return x, z, r


# ---------------------------------------------------------------------------
# Pauli expectation in-tableau
# ---------------------------------------------------------------------------
def pauli_expectation_tableau(tab, px: torch.Tensor, pz: torch.Tensor,
                              y_count: int, n: int) -> torch.Tensor:
    """⟨P⟩ on stabilizer states: exactly 0 or ±1 (float32, one per
    tableau of a batch).

    px/pz: bool[n] supports of P (Y → both). The Pauli is
    P = i^{y_count}·Π X^{px} Z^{pz} with + sign.
    """
    x, z, r = tab
    single = x.dim() == 2
    if single:
        x, z, r = x[None], z[None], r[None]
    px, pz = px.to(x.device), pz.to(x.device)
    dx, dz = x[:, :n], z[:, :n]             # destabilizers
    sx_, sz_ = x[:, n:], z[:, n:]           # stabilizers
    sr = r[:, n:]

    def odd(a):
        return (a.sum(-1) % 2).bool()

    # anticommutation with any stabilizer → ⟨P⟩ = 0
    is_zero = odd((sx_ & pz) ^ (sz_ & px)).any(-1)
    # which stabilizer generators multiply to P: c_i = P anticommutes with
    # destabilizer i
    c = odd((dx & pz) ^ (dz & px))                       # [B, n]
    # the product Π_i S_i^{c_i} has phase exponent u (mod 4), where a row's
    # operator is i^{2r + y_row}·X^x Z^z: u = Σ_{i: c_i} (u_row_i + cross_i),
    # cross_i = 2·|az_<i ∧ x_i| with az_<i the XOR of the z rows taken
    # before i
    u_row = 2 * sr.long() + (sx_ & sz_).sum(-1)
    taken_z = (c[..., None] & sz_).long()
    az_before = (torch.cumsum(taken_z, dim=1) - taken_z) % 2
    cross = 2 * (az_before.bool() & sx_).sum(-1)
    u = (torch.where(c, u_row + cross, torch.zeros_like(u_row)).sum(-1)) % 4
    diff = (u - y_count % 4) % 4
    one = torch.ones(u.shape, dtype=torch.float32, device=u.device)
    out = torch.where(is_zero, torch.zeros_like(one),
                      torch.where(diff == 0, one, -one))
    return out[0] if single else out


def _pauli_supports(term, n: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
    codes = term.codes()[:n]
    return (torch.as_tensor(np.isin(codes, (1, 2))),
            torch.as_tensor(np.isin(codes, (2, 3))),
            int(np.sum(codes == 2)))


# ---------------------------------------------------------------------------
# High-level API
# ---------------------------------------------------------------------------
class StabilizerState:
    """Host-friendly wrapper over an evolved tableau."""

    def __init__(self, tab, n: int):
        self.tab = tab
        self.n = n

    @classmethod
    def from_circuit(cls, circuit: Circuit, device: Device = "cuda"
                     ) -> "StabilizerState":
        types, qubits = decompose_to_primitives(circuit)
        return cls(run_tableau(types, qubits, circuit.num_qubits, device),
                   circuit.num_qubits)

    def expectation(self, obs: PauliSum) -> float:
        total = 0.0
        for term in obs.terms:
            px, pz, y_count = _pauli_supports(term, self.n)
            total += float(np.real(term.coeff)) * float(
                pauli_expectation_tableau(self.tab, px, pz, y_count, self.n))
        return total

    def stabilizer_strings(self) -> List[str]:
        """Stabilizer generators as ±PAULI strings (qiskit order:
        leftmost char = highest qubit), parity with ``Clifford.to_dict()
        ['stabilizer']`` consumed by ``force_nonzero_expectation``."""
        x, z, r = (t.cpu().numpy() for t in self.tab)
        out = []
        for i in range(self.n, 2 * self.n):
            chars = ["IXZY"[int(x[i, q]) + 2 * int(z[i, q])]
                     for q in reversed(range(self.n))]
            out.append(("-" if r[i] else "+") + "".join(chars))
        return out


def batch_expectations(circuits: Sequence[Circuit], obs: PauliSum,
                       device: Device = "cuda") -> np.ndarray:
    """⟨P⟩ for a batch of same-width Clifford circuits (one tableau run)."""
    n = circuits[0].num_qubits
    streams = [decompose_to_primitives(c) for c in circuits]
    max_len = max(s[0].shape[0] for s in streams)
    types = np.full((len(circuits), max_len), _PRIM_NOP, np.int32)
    qubits = np.zeros((len(circuits), max_len, 2), np.int32)
    for i, (t, q) in enumerate(streams):
        types[i, :t.shape[0]] = t
        qubits[i, :q.shape[0]] = q
    tabs = run_tableau(types, qubits, n, device)
    vals = np.zeros(len(circuits))
    for term in obs.terms:
        px, pz, y_count = _pauli_supports(term, n)
        vals += np.real(term.coeff) * pauli_expectation_tableau(
            tabs, px, pz, y_count, n).cpu().numpy()
    return vals


def force_nonzero_expectation(circuit: Circuit, print_bool: bool = False,
                              device: Device = "cuda"
                              ) -> Tuple[Circuit, int]:
    """Rotate the measurement basis so an all-Z observable has ⟨·⟩ = ±1.

    Parity with ``force_nonzero_expectation_from_clifford_circuit``
    (``mbd_utils.py:208-259``): pick the first stabilizer with no identity
    factor, append basis-change gates per qubit, return (circuit, ±1).
    Raises UserWarning if every stabilizer contains an I.
    """
    state = StabilizerState.from_circuit(circuit, device)
    stabilizer = next((s for s in state.stabilizer_strings() if "I" not in s),
                      None)
    if stabilizer is None:
        raise UserWarning("All of the stabilizers have the identity matrix I!")
    if print_bool:
        print(f"Stabilizer: {stabilizer}")
    out = circuit.copy()
    n = circuit.num_qubits
    for qubit in range(n):
        op = stabilizer[n - qubit]  # char for this qubit (after sign char)
        if op == "X":
            out.h(qubit)
        elif op == "Y":
            out.sdg(qubit)
            out.h(qubit)
    return out, 1 if stabilizer[0] == "+" else -1


def construct_random_clifford(num_qubit: int, depth: int,
                              max_operands: int = 2,
                              seed: Optional[int] = None,
                              device: Device = "cuda"
                              ) -> Tuple[Circuit, bool]:
    """``construct_random_clifford`` parity (``mbd_utils.py:314-325``)."""
    from ..circuits.families import random_clifford_circuit

    rc = random_clifford_circuit(num_qubit, depth, max_operands, seed)
    try:
        forced, _ = force_nonzero_expectation(rc, device=device)
        enforced = True
    except UserWarning:
        forced, enforced = rc, False
    forced.measure_all()
    return forced, enforced


def clifford_inverse_circuit(circuit: Circuit) -> Circuit:
    """Circuit realizing the exact inverse Clifford: the reversed adjoint
    op sequence (depth scales with the input rather than the
    single-element inverse of textbook RB; only the composed identity
    matters for dataset generation)."""
    return circuit.inverse()
