"""Amplitude-sharded statevector simulation over the mesh's ``sp`` ranks.

Counterpart of ``mlqem_tpu/ops/sharded_sv.py``. The 2^n amplitude vector
is split over the ``sp`` ranks of a :func:`~..parallel.mesh.make_mesh`
mesh, so a state wider than one device spans several:

* the top k qubits (k = log2(#shards)) are *global*: their bit value is
  the shard's sp rank; the other n−k are local;
* gates on local qubits apply shard-locally (:func:`.statevector.apply_op`,
  the single-device engine's bit gather);
* a gate that touches a global qubit swaps blocks with the partner rank
  whose sp rank differs in that bit (``dist.batch_isend_irecv``; JAX's
  ``lax.ppermute`` with partner i ^ m), then combines them locally.

The circuit is unrolled on the host once, in :func:`build_sharded_apply`
(qubit indices fixed per op, so every op's exchanges are fixed), and the
parameters are an argument: a parameter sweep reuses the structure, as
JAX's traced parameters reuse the compiled program. Amplitudes are
complex64 throughout, and no op is a matrix product.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..circuits.circuit import Circuit, tensorize
from ..circuits.gates import GATE_NUM_QUBITS, is_structural
from ..parallel.mesh import Device, mesh_device
from .statevector import apply_op
from .unitaries import COMPLEX_DTYPE, insert_bit, op_unitaries


def _apply_1q_local(state, mat2, q, n_local):
    """2x2 gate on local qubit q of state[2^n_local]: the 4x4 path (U⊗I on
    (q, q+1)) of the single-device engine, or a 2x2 product when the block
    holds one qubit (JAX's 4x4 path there relies on clamped gathers)."""
    if n_local == 1:
        return torch.stack([mat2[0, 0] * state[0] + mat2[0, 1] * state[1],
                            mat2[1, 0] * state[0] + mat2[1, 1] * state[1]])
    mat4 = torch.kron(mat2, torch.eye(2, dtype=mat2.dtype,
                                      device=mat2.device))
    return apply_op(state, mat4, q, (q + 1) % n_local, n_local)


def _exchange(state, mask, mesh):
    """The block of the sp rank s ^ mask (this rank's s): ``ppermute``."""
    s = mesh.get_local_rank("sp")
    peer = int(mesh.mesh[mesh.get_local_rank("dp"), s ^ mask])
    group = mesh.get_group("sp")
    theirs = torch.empty_like(state)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, torch.view_as_real(state), peer, group),
        dist.P2POp(dist.irecv, torch.view_as_real(theirs), peer, group)])
    for req in reqs:
        req.wait()
    return theirs


def build_sharded_apply(circuit: Circuit, n_shards: int,
                        dtype=COMPLEX_DTYPE) -> Callable:
    """fn(local_state, params[L, 3], mesh) applying the circuit to this
    rank's block of the sharded state.

    Gate structure (ids, qubits) is unrolled here; parameters are an
    argument, so sweeps reuse it.
    """
    n = circuit.num_qubits
    k = int(np.log2(n_shards))
    if 2 ** k != n_shards:
        raise ValueError("shard count must be a power of two")
    n_local = n - k
    if n_local < 1:
        raise ValueError("need at least 1 local qubit")
    ops = [op for op in circuit.ops if not is_structural(op.name)]
    gate_ids = tensorize(circuit).gate_ids

    def apply_fn(state, params, mesh: DeviceMesh):
        s = mesh.get_local_rank("sp")
        params = torch.as_tensor(np.asarray(params), dtype=torch.float32,
                                 device=state.device)
        mats = op_unitaries(gate_ids, params).to(dtype)    # [L, 4, 4]
        for l, op in enumerate(ops):
            mat4 = mats[l]
            if GATE_NUM_QUBITS.get(op.name, 1) == 1:
                q = op.qubits[0]
                # U⊗I embedding: the 2x2 acting on the first slot
                mat2 = mat4[0::2, 0::2]
                if q < n_local:
                    state = _apply_1q_local(state, mat2, q, n_local)
                else:
                    g = q - n_local
                    theirs = _exchange(state, 1 << g, mesh)
                    b = (s >> g) & 1
                    state = mat2[b, b] * state + mat2[b, 1 - b] * theirs
                continue
            a, b = op.qubits[0], op.qubits[1]
            a_loc, b_loc = a < n_local, b < n_local
            if a_loc and b_loc:
                state = apply_op(state, mat4, a, b, max(n_local, 2))
            elif not a_loc and not b_loc:
                ga, gb = a - n_local, b - n_local
                sa = _exchange(state, 1 << ga, mesh)
                sb = _exchange(state, 1 << gb, mesh)
                sab = _exchange(state, (1 << ga) | (1 << gb), mesh)
                va, vb = (s >> ga) & 1, (s >> gb) & 1
                m_my = 2 * va + vb
                # the blocks by their local index m: mine, flip-b,
                # flip-a, flip-both
                new = 0.0
                for blk, m_in in ((state, m_my), (sb, 2 * va + 1 - vb),
                                  (sa, 2 * (1 - va) + vb),
                                  (sab, 2 * (1 - va) + 1 - vb)):
                    new = new + mat4[m_my, m_in] * blk
                state = new
            else:
                # one global, one local: index the 4x4 as m = 2·v_g + v_q
                if a_loc:
                    perm = [0, 2, 1, 3]
                    mat4 = mat4[perm][:, perm]
                    g, q = b - n_local, a
                else:
                    g, q = a - n_local, b
                theirs = _exchange(state, 1 << g, mesh)
                vg = (s >> g) & 1
                base = torch.arange(2 ** (n_local - 1), dtype=torch.int64,
                                    device=state.device)
                idx0 = insert_bit(base, q)                  # v_q = 0
                idx1 = idx0 | (1 << q)                      # v_q = 1
                comp = {(blk_v, vq): blk[idx]
                        for blk_v, blk in ((vg, state), (1 - vg, theirs))
                        for vq, idx in ((0, idx0), (1, idx1))}
                out = torch.empty_like(state)
                for vq_out, idx in ((0, idx0), (1, idx1)):
                    row = 2 * vg + vq_out
                    out[idx] = sum(mat4[row, 2 * v + vq] * comp[(v, vq)]
                                   for v in (vg, 1 - vg) for vq in (0, 1))
                state = out
        return state

    return apply_fn


def sharded_statevector_fn(circuit: Circuit, mesh: DeviceMesh,
                           device: Device = "cuda",
                           dtype=COMPLEX_DTYPE) -> Callable:
    """fn(params[L, 3]) → this rank's block of |ψ⟩ (2^n over the sp ranks;
    the blocks concatenate in sp-rank order into the global vector), on
    ``device``, which must be of the mesh's device type."""
    device = torch.device(device)
    if device.type != mesh.device_type:
        raise ValueError(f"device {device} is not on the mesh's "
                         f"{mesh.device_type!r} ranks")
    n_shards = mesh.size(1)
    n_local = circuit.num_qubits - int(np.log2(n_shards))
    apply_fn = build_sharded_apply(circuit, n_shards, dtype)
    device = mesh_device(mesh)

    def fn(params):
        local = torch.zeros(2 ** n_local, dtype=dtype, device=device)
        if mesh.get_local_rank("sp") == 0:
            local[0] = 1.0
        return apply_fn(local, params, mesh)

    return fn


def gather_state(local: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The whole 2^n vector on every rank: the sp blocks all-gathered in
    sp-rank order (JAX's ``np.asarray`` of the sharded array)."""
    if mesh.size(1) == 1:
        return local
    parts = [torch.empty_like(local) for _ in range(mesh.size(1))]
    dist.all_gather(parts, local.contiguous(), group=mesh.get_group("sp"))
    return torch.cat(parts)


def sharded_z_expectations(local: torch.Tensor, circuit_n: int,
                           mesh: DeviceMesh) -> np.ndarray:
    """Per-qubit ⟨Z⟩ of an amplitude-sharded state, as numpy on every rank
    (the blocks' sums all-reduced over sp: JAX's ``psum``)."""
    n_local = circuit_n - int(np.log2(mesh.size(1)))
    s = mesh.get_local_rank("sp")
    probs = local.real * local.real + local.imag * local.imag
    vals = []
    for q in range(circuit_n):
        if q < n_local:
            p = probs.reshape(-1, 2, 2 ** q).sum(dim=(0, 2))
            vals.append(p[0] - p[1])
        else:
            sign = 1 - 2 * ((s >> (q - n_local)) & 1)
            vals.append(sign * probs.sum())
    vals = torch.stack(vals)
    if mesh.size(1) > 1:
        dist.all_reduce(vals, group=mesh.get_group("sp"))
    return vals.cpu().numpy()
