"""The device mesh: the port's parallelism layer, on ``torch.distributed``.

Counterpart of ``mlqem_tpu/parallel/mesh.py``. The JAX package runs one
SPMD program over a (dp, sp) mesh: the circuit batch sharded over ``dp``,
and for large statevectors the amplitudes over ``sp``, with XLA inserting
the collectives. Here every rank is a process of the default process
group, the mesh is PyTorch's own ``DeviceMesh`` with the dimension names
``("dp", "sp")``, and the collectives are explicit.

The layout is the JAX package's: ``np.asarray(devices).reshape(dp, sp)``
is row-major, so rank = d·sp + s and the sp shards of a state concatenate
in rank order into the global vector.

What stands for what:

* ``Mesh`` → ``DeviceMesh`` (:func:`make_mesh`);
* ``batch_sharding`` / ``shard_circuit_batch`` (a batch's leading axis on
  ``dp``) → :func:`shard_rows`, the indices of this rank's rows of the
  batch padded to a multiple of dp (the pad repeats the last row, as
  :func:`pad_to_multiple` does);
* ``replicated`` (an output every device holds in full) →
  :func:`gather_rows`, the all-gather of every dp index's rows with the
  pad cut off;
* ``psum`` with gradients → :func:`all_reduce_sum`;
* launching the ranks (a virtual CPU mesh in JAX) → :func:`spawn`.
"""
from __future__ import annotations

import os
import tempfile
import traceback
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

Device = Union[str, torch.device]
# how long spawn waits for a rank's result before it stops the ranks
RANK_TIMEOUT_S = 900.0


def make_mesh(dp: Optional[int] = None, sp: int = 1,
              device: Device = "cuda") -> DeviceMesh:
    """A (dp, sp) ``DeviceMesh`` over the ranks of the default group.

    ``dp`` defaults to world size // sp. With no process group yet, a
    one-rank group starts on ``device`` (NCCL for the card, gloo for the
    CPU, an in-memory store): the path of one card.
    """
    device = torch.device(device)
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    n = dist.get_world_size()
    if dp is None:
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"dp*sp = {dp * sp} != {n} ranks")
    return init_device_mesh(device.type, (dp, sp),
                            mesh_dim_names=("dp", "sp"))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors live on for ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def pad_to_multiple(arrays: Dict[str, np.ndarray], multiple: int
                    ) -> Tuple[Dict[str, np.ndarray], int]:
    """Pad a batch's leading dim up to a device-count multiple.

    Returns (padded arrays, original size): sharding over dp needs the
    batch divisible by dp. The pad repeats the last row.
    """
    n = next(iter(arrays.values())).shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return arrays, n
    out = {}
    for k, v in arrays.items():
        pad_width = [(0, pad)] + [(0, 0)] * (v.ndim - 1)
        out[k] = np.pad(v, pad_width, mode="edge")
    return out, n


def shard_rows(n: int, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's rows of an n-row batch: int64 indices into it.

    The batch is padded to a multiple of dp by repeating its last row
    (:func:`pad_to_multiple`'s pad) and each dp index takes its contiguous
    block, so rank (d, s) reads the same rows for every s.
    """
    dp = mesh.size(0)
    per = -(-n // dp)
    start = mesh.get_local_rank("dp") * per
    return torch.arange(start, start + per).clamp_(max=n - 1)


def gather_rows(x: torch.Tensor, mesh: DeviceMesh, n: int) -> torch.Tensor:
    """Every dp index's rows of ``x`` in order, the pad cut off: the first
    n rows of the padded batch, on every rank."""
    if mesh.size(0) == 1:
        return x[:n]
    parts = [torch.empty_like(x) for _ in range(mesh.size(0))]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group("dp"))
    return torch.cat(parts)[:n]


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the gradient is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``psum``: the sum of ``x`` over ``group`` on every rank, with
    gradients (the backward pass sums the ranks' gradients)."""
    return _AllReduceSum.apply(x, group)


def _rank_main(fn, rank, world_size, device, init_file, results, args):
    try:
        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(rank)
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method="file://" + init_file, rank=rank,
            world_size=world_size)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out if rank == 0 else None))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn: Callable, world_size: int, device: Device, *args):
    """Run ``fn(*args)`` on ``world_size`` new ranks; return rank 0's result.

    Each rank is a process started by ``torch.multiprocessing`` with the
    spawn method and joins a process group (NCCL on ``cuda:<rank>`` for
    the card, gloo for the CPU) that meets through a file in a fresh
    temporary directory. ``fn`` and ``args`` are pickled, so ``fn`` is a
    module-level function the children can import. A rank that fails, or
    gives no result within ``RANK_TIMEOUT_S``, raises here (with its
    traceback) and the ranks are stopped.
    """
    device = torch.device(device)
    if device.type == "cuda" and world_size > torch.cuda.device_count():
        raise ValueError(f"{world_size} ranks need {world_size} cards; "
                         f"{torch.cuda.device_count()} visible")
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, args=(
            fn, rank, world_size, str(device), os.path.join(tmp, "init"),
            results, args)) for rank in range(world_size)]
        for p in procs:
            p.start()
        try:
            got = {}
            for _ in range(world_size):
                rank, ok, out = results.get(timeout=RANK_TIMEOUT_S)
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world_size} "
                                       f"failed:\n{out}")
                got[rank] = out
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
    return got[0]
