"""Static-structure density-matrix engine for template batches, in torch.

Counterpart of ``mlqem_tpu/ops/density_static.py``, the engine of
``IsingLabelPipeline(method="density_matrix")``. For a shared-topology
batch every op's qubit pair is known on the host, so a 16×16 superoperator
applies with no index gather: the density matrix's row and column bits of
the pair become explicit size-2 axes, one permute brings the four of them
to the front, the superop contracts them as one batched
``[16, 16] @ [16, dim²/16]`` matmul over a dense minor axis, and one
permute puts them back (the JAX package's "transpose" form; its "einsum"
name is accepted for the same result).

The work of a batch is (1) a host-side plan, :func:`superop_plan`: the
per-op superops, fused exactly (:func:`fuse_superops`: NOP skip, 1q
absorption, disjoint-commutation merge) and optionally paired into 4-qubit
ops (:func:`pair_disjoint_superops`); (2) the sweep, :func:`apply_plan`:
one full pass over the batch's density matrices per planned op. Every
product is a matmul guarded by :func:`check_ieee_matmul` (the JAX engine
pins ``Precision.HIGHEST``) or an elementwise outer product.
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..circuits.circuit import CircuitTensor
from ..circuits.gates import GATE_NAMES, GATE_NUM_QUBITS
from .density import gate_superop, matmul
from .static_sv import static_pairs
from .unitaries import COMPLEX_DTYPE, op_unitaries

_PERM_SWAP = np.array([0, 2, 1, 3])
VARIANTS = ("transpose", "einsum")


def _check_variant(variant: Optional[str]) -> None:
    """The JAX package's variant names, all one computation here."""
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"unknown superop variant {variant!r} "
                         f"({' | '.join(VARIANTS)})")

# flat 16-index (= 4·(2Ra+Rb) + (2Ca+Cb)) of the slot-0 subspace with the
# slot-1 bits Rb=Cb=0, ordered by the 1q superop index 2Ra+Ca
_SLOT0_IDX = np.array([0, 2, 8, 10])


def _perm_16(swap_row: bool) -> np.ndarray:
    """Permutation of the 16 superop indices when (a > b) ordering flips."""
    if not swap_row:
        return np.arange(16)
    # k = 4p + q with p, q ∈ {0..3}: permute p and q by [0,2,1,3]
    out = np.zeros(16, np.int64)
    for p in range(4):
        for q in range(4):
            out[4 * p + q] = 4 * _PERM_SWAP[p] + _PERM_SWAP[q]
    return out


def _swap_slots(s16: torch.Tensor) -> torch.Tensor:
    """s16 [..., 16, 16] with its two slots exchanged on both sides."""
    perm = torch.as_tensor(_perm_16(True), device=s16.device)
    return s16[..., perm, :][..., :, perm]


def apply_superop_multi(dm: torch.Tensor, sK: torch.Tensor,
                        qs: Tuple[int, ...], n: int) -> torch.Tensor:
    """Apply a 4^k × 4^k superop at k distinct STATIC qubits to
    dm[..., 2^n, 2^n].

    ``qs`` gives the superop's slot order (slot 0 = MSB of the local
    row/col index), so the dm's bit axes are gathered in exactly that
    order: one permute to [..., 4^k, dim²/4^k], the matmul, one permute
    back. Returns a new tensor.
    """
    k = len(qs)
    batch = dm.shape[:-2]
    nb = len(batch)
    dim = 2 ** n
    view = dm.reshape(batch + (2,) * (2 * n))
    front = ([nb + (n - 1 - q) for q in qs]
             + [nb + n + (n - 1 - q) for q in qs])
    rest = [i for i in range(nb, nb + 2 * n) if i not in front]
    axperm = list(range(nb)) + front + rest
    moved = view.permute(axperm).reshape(batch + (4 ** k, dim * dim // 4 ** k))
    out = matmul(sK, moved)
    del moved
    back = out.reshape(batch + (2,) * (2 * n)).permute(
        list(np.argsort(axperm)))
    return back.reshape(batch + (dim, dim))


def apply_superop_static(dm: torch.Tensor, s16: torch.Tensor, a: int, b: int,
                         n: int, variant: str = "transpose") -> torch.Tensor:
    """Apply a 16×16 superop at STATIC qubits (a, b) to dm[..., 2^n, 2^n].

    s16 [..., 16, 16] may carry leading batch dims broadcasting with dm's;
    its slot 0 is qubit a. The JAX package permutes s16's indices by
    ``_perm_16(True)`` when a < b, to match bit axes taken high bit
    first; here the axes are taken in slot order (a, b), the same
    contraction. ``variant`` "transpose" or "einsum" (the JAX package's
    two names) give the same result.
    """
    _check_variant(variant)
    return apply_superop_multi(dm, s16, (a, b), n)


def _factor_slot0(s16: np.ndarray) -> Optional[np.ndarray]:
    """Host-side: the 4×4 S with ``s16 == S ⊗ I`` (slot-0 action), or None.

    ``compile_noise_table`` lifts 1q channels with ``expand_to_2q(0)``
    (identity on the embedding partner), so 1q-op noise superops factor
    this way by construction; the numeric check keeps the fusion pass
    safe against any channel that does not.
    """
    s4 = s16[np.ix_(_SLOT0_IDX, _SLOT0_IDX)]
    a_r = s4.reshape(2, 2, 2, 2)                 # [Ra, Ca, Ra', Ca']
    eye = np.eye(2)
    lifted = np.einsum("ACac,Bb,Dd->ABCDabcd", a_r, eye, eye).reshape(16, 16)
    return s4 if np.allclose(lifted, s16, atol=1e-12) else None


def _outer_slots(sa: torch.Tensor, sb: torch.Tensor, da: int, db: int
                 ) -> torch.Tensor:
    """Superop of two disjoint slot groups: sa [B, da², da²] on the leading
    slots, sb [B, db², db²] on the trailing ones → [B, (da·db)², (da·db)²].

    Flat index = D·row + col with row/col the slot-major local indices, so
    the combined order is (row_a, row_b, col_a, col_b): the JAX package's
    einsum "zACac,zBDbd->zABCDabcd", written as an outer product.
    """
    B = max(sa.shape[0], sb.shape[0])
    a_r = sa.reshape(-1, da, da, da, da)[:, :, None, :, None, :, None, :, None]
    b_r = sb.reshape(-1, db, db, db, db)[:, None, :, None, :, None, :, None, :]
    d = da * db
    return (a_r * b_r).reshape(B, d * d, d * d)


def _lift_pair(s4a, s4b, B: int, device) -> torch.Tensor:
    """16×16 superop (first, second) from per-slot 4×4 superops [B, 4, 4];
    ``None`` means identity on that slot."""
    eye = torch.eye(4, dtype=COMPLEX_DTYPE, device=device)[None]
    a = eye if s4a is None else s4a
    b = eye if s4b is None else s4b
    return _outer_slots(a, b, 2, 2).expand(B, 16, 16)


def _lift_disjoint(sa: torch.Tensor, sb: torch.Tensor, B: int,
                   da: int) -> torch.Tensor:
    """(4·da)²-dim superop from sa (da²×da², leading slots) and sb
    (16×16, trailing two slots) on disjoint qubits."""
    return _outer_slots(sa, sb, da, 4).expand(B, -1, -1)


# forward-scan window for the disjoint pairing pass
_PAIR_SCAN = 32


def pair_disjoint_superops(ops):
    """Pair disjoint-support 16×16 ops into 4-qubit 256×256 superops.

    Input [(a, b, s16)]; output entries are ("s16", a, b, s16) or
    ("s256", qs, s256). Op j merges back to op i's position only when
    every unmerged op between them has support disjoint from op j's
    (commutation), so the composed channel sequence is unchanged: half the
    full-dm passes at 16× the matmul work per pass.
    """
    items = [{"qs": (a, b), "s": s16, "merged": False}
             for a, b, s16 in ops]
    plan = []
    for i, it in enumerate(items):
        if it["merged"]:
            continue
        sup = set(it["qs"])
        paired = False
        blocked: set = set()
        for j in range(i + 1, min(i + 1 + _PAIR_SCAN, len(items))):
            jt = items[j]
            if jt["merged"]:
                continue
            js = set(jt["qs"])
            if js & sup or js & blocked:
                blocked |= js
                continue
            jt["merged"] = True
            B = it["s"].shape[0]
            plan.append(("s256", it["qs"] + jt["qs"],
                         _lift_disjoint(it["s"], jt["s"], B, 4)))
            paired = True
            break
        if not paired:
            plan.append(("s16", it["qs"][0], it["qs"][1], it["s"]))
    return plan


# backward-scan window for the disjoint-commutation merge
_MERGE_SCAN = 64


def fuse_superops(pairs, gate_ids, keys, table, mats: torch.Tensor, B: int,
                  n: int) -> List[Tuple[int, int, torch.Tensor]]:
    """Fused per-op superop plan: [(a, b, s16[B, 16, 16])] in (first,
    second) slot order, applying the SAME channel sequence as the
    one-superop-per-slot path with far fewer full-dm passes.

    ``table`` is the host complex noise table [K, 16, 16]; ``mats`` the
    batch's op unitaries [B, L, 4, 4] on the device. Exact transformations
    only (the composed linear maps are identical up to float reassociation):

    - **NOP skip**: padding slots (gate 0, noise key 0) are identity
      superops, dropped instead of costing a full dm pass each.
    - **1q absorption**: a 1q op's superop factors as S4 ⊗ I (unitary
      U ⊗ I by the embedding convention, noise ``expand_to_2q(0)``,
      checked on the host by :func:`_factor_slot0`), so it accumulates into
      a per-qubit pending 4×4 and composes into the next emitted op that
      touches the qubit. Channels on disjoint qubits commute, so the
      deferral is exact.
    - **Disjoint-commutation merge**: an emitted op merges into the most
      recent emitted op on the SAME qubit set when every emitted op in
      between has disjoint support (the cx–rz–cx sandwich of a lowered rzz
      becomes ONE 16×16 after the rz absorbs); a merged op is first
      realigned to the earlier op's slot order.

    On the bench Ising template (10q, 4 Trotter steps: 148 slots) the plan
    has 36 superops, one per bond and step: the trailing rx layer pairs up
    and merges back into the last bond layer.
    """
    gate_ids = np.asarray(gate_ids).reshape(-1)
    device = mats.device
    table = np.asarray(table, np.complex64)
    table_d = torch.as_tensor(table, device=device)
    pending: dict = {}                    # qubit -> s4 [B, 4, 4]
    emitted: List[list] = []              # [a, b, support, s16]

    def emit(a: int, b: int, s16) -> None:
        for e in reversed(emitted[-_MERGE_SCAN:]):
            if e[2] == {a, b}:
                if (e[0], e[1]) != (a, b):   # align slot order to e's
                    s16 = _swap_slots(s16)
                e[3] = matmul(s16, e[3])
                return
            if e[2] & {a, b}:
                break
        emitted.append([a, b, {a, b}, s16])

    for l, (a, b) in enumerate(pairs):
        g = int(gate_ids[l])
        key = int(keys[l])
        if g == 0 and key == 0:
            continue                      # identity superop: skip the pass
        name = GATE_NAMES[g] if 0 <= g < len(GATE_NAMES) else ""
        is1q = GATE_NUM_QUBITS.get(name, 1) == 1
        s4n = None
        if is1q and key != 0:
            s4n = _factor_slot0(table[key].astype(np.complex128))
        if is1q and (key == 0 or s4n is not None):
            s4 = gate_superop(mats[:, l, 0::2, 0::2])  # U from U ⊗ I
            if s4n is not None:
                s4 = matmul(torch.as_tensor(s4n.astype(np.complex64),
                                            device=device), s4)
            p = pending.get(a)
            pending[a] = s4 if p is None else matmul(s4, p)
            continue
        s16 = gate_superop(mats[:, l])    # 2q (or unfactorable-noise) op
        if key != 0:
            s16 = matmul(table_d[key], s16)
        pa, pb = pending.pop(a, None), pending.pop(b, None)
        if pa is not None or pb is not None:
            s16 = matmul(s16, _lift_pair(pa, pb, B, device))
        emit(a, b, s16)

    left = sorted(pending)                # trailing 1q layers, pairwise
    while left:
        qa = left.pop(0)
        if left:
            qb = left.pop(0)
            emit(qa, qb, _lift_pair(pending[qa], pending[qb], B, device))
        else:
            qb = (qa + 1) % n             # any partner: identity on slot 1
            emit(qa, qb, _lift_pair(pending[qa], None, B, device))
    return [(a, b, s16) for a, b, _, s16 in emitted]


def _host_table(noise_table) -> np.ndarray:
    if torch.is_tensor(noise_table):
        noise_table = noise_table.cpu().numpy()
    return np.asarray(noise_table, np.complex64)


def superop_plan(ct_struct: CircuitTensor, params: torch.Tensor,
                 key_ids: np.ndarray, noise_table, fuse: bool = True,
                 pair4: bool = False) -> list:
    """The sweep's ops for a template batch: params [B, L, 3] on the device.

    Entries are ("s16", a, b, s16[B, 16, 16]) or ("s256", qs,
    s256[B, 256, 256]). ``fuse`` runs :func:`fuse_superops`, else one
    superop per op slot; ``pair4`` also pairs disjoint fused superops
    (:func:`pair_disjoint_superops`).
    """
    n = max(ct_struct.num_qubits, 2)
    pairs = static_pairs(ct_struct)
    keys = np.asarray(key_ids).reshape(-1)
    table = _host_table(noise_table)
    params = torch.as_tensor(params, dtype=torch.float32)
    B = params.shape[0]
    mats = op_unitaries(ct_struct.gate_ids, params)         # [B, L, 4, 4]
    if fuse:
        ops = fuse_superops(pairs, ct_struct.gate_ids, keys, table, mats,
                            B, n)
    else:
        table_d = torch.as_tensor(table, device=params.device)
        ops = [(a, b, matmul(table_d[int(keys[l])], gate_superop(mats[:, l])))
               for l, (a, b) in enumerate(pairs)]
    if pair4:
        return pair_disjoint_superops(ops)
    return [("s16", a, b, s16) for a, b, s16 in ops]


def apply_plan(plan: list, batch: int, n: int,
               device: Union[str, torch.device]) -> torch.Tensor:
    """Run a :func:`superop_plan` from |0…0⟩⟨0…0|: complex64 [B, 2^n, 2^n].

    The plan's entries are consumed (popped) as they run, so each op's
    superops are freed once applied.
    """
    dim = 2 ** n
    dm = torch.zeros((batch, dim, dim), dtype=COMPLEX_DTYPE, device=device)
    dm[:, 0, 0] = 1.0
    plan.reverse()
    while plan:
        entry = plan.pop()
        if entry[0] == "s16":
            _, a, b, s16 = entry
            dm = apply_superop_multi(dm, s16, (a, b), n)
        else:
            _, qs, s256 = entry
            dm = apply_superop_multi(dm, s256, qs, n)
        del entry
    return dm


def run_density_static(ct_struct: CircuitTensor, params: torch.Tensor,
                       key_ids: np.ndarray, noise_table,
                       variant: Optional[str] = None, fuse: bool = True,
                       pair4: Optional[bool] = None) -> torch.Tensor:
    """Noisy density matrices for a template batch: params [B, L, 3].

    key_ids/noise_table as produced by ``compile_noise_table`` on the
    template (shared across the batch; the table as numpy or a tensor).
    Returns dm complex64 [B, 2^n, 2^n] on params' device. ``variant``:
    None, "transpose" or "einsum", all the same computation here.

    ``fuse=True`` (default) runs the exact superop-fusion plan
    (:func:`fuse_superops`); ``fuse=False`` applies one superop per op
    slot. ``pair4`` additionally pairs disjoint fused superops into
    4-qubit 256×256 ops: half the full-dm passes at 16× the matmul work.
    Default off, as the JAX package's default off the TPU.
    """
    _check_variant(variant)
    params = torch.as_tensor(params, dtype=torch.float32)
    plan = superop_plan(ct_struct, params, key_ids, noise_table, fuse=fuse,
                        pair4=bool(pair4))
    return apply_plan(plan, params.shape[0], max(ct_struct.num_qubits, 2),
                      params.device)
