"""``KickedIsingEngine.generate(mesh=)`` on persistent ranks, one a card:
the 10-qubit training pairs with the batch sharded over the
configuration's (dp, sp) mesh (NCCL on the cards, gloo on the CPU).

The ranks are started by the port's ``mlqem_tpu_torch.parallel.mesh.
spawn`` in the constructor and live until ``release()`` (at most
``spawn``'s ``RANK_TIMEOUT_S``). Each builds its engine on
``mesh_device(make_mesh(dp, sp))`` and answers each call with
``engine.generate(J, seed=s, mesh=mesh)``: the whole batch's labels on
every rank. The couplings J reach the ranks, and rank 0's labels the
driving process, through CPU memory they share (a queue pickles 5 MB
through a pipe in ~20 ms); the queues carry the seed and the replies. Every rank replies with the CRC-32 of its labels' bytes; a call
whose ranks' checksums differ raises, so the harness counts it as failed:
the deployment guarantees that every rank holds the same labels, those of
the unsharded call. A call that raises on a rank fails too. The driving
process stands for the client that trains on the pairs: each call ends
with the labels copied onto card 0, its only device work (the ranks' is
read from their spans).

Each rank resets its peak as ``warm()`` ends and reports
``max_memory_allocated()`` to ``device_peaks()``. In a traced run the
ranks record their first ``trace_calls`` calls under ``tracing()`` and
hand their ``span_totals()`` to the driving process in ``release()``,
which folds them under ``mesh.rank<r>/`` (``profiling.fold_spans``, where
the program has it; the per-layer metrics then read them by path suffix).

Every wait on a rank has a timeout. A rank that fails, or does not answer
in time, stops every rank, and each later request raises at once: a run
fails, never hangs.

The ranks are processes of their own, so a fault that ``faults.plant``
planted in the driving process is planted again in every rank. The
exchange's faults are this module's: ``rows_swapped`` (rank 0's rows
gathered in rank 1's place, on every rank) and ``rank_diverges`` (the last
rank alone runs with ``answer_altered``): an entry with either is
``with_fault(name)``.
"""
from __future__ import annotations

import atexit
import contextlib
import multiprocessing
import queue
import sys
import threading
import time
import traceback
import zlib

import numpy as np
import torch
import torch.distributed as dist

from .. import calibration, faults
from . import TF32, shot_mean
from . import kicked

# seconds the ranks may take to start, build their engines and answer their
# first call (the kernels may be built then), and to answer a later request
START_S = 900.0
CALL_S = 120.0
# a rank that hears nothing from the driving process this long ends
IDLE_S = 3600.0

EXCHANGE_FAULTS = ("rows_swapped", "rank_diverges")


def planted_fault():
    """The fault of ``faults.py`` that ``faults.plant`` planted in this
    process, if any: the name of the first whose patch is found."""
    from mlqem_tpu_torch.ops import kicked_ising as ki
    from mlqem_tpu_torch.ops.kernels import evolve as k1

    eng = ki.KickedIsingEngine
    marks = {"step_unchanged": (k1, "evolve_fused"),
             "half_batch": (eng, "shot_labels"),
             "answer_altered": (eng, "generate"),
             "readout_dropped": (eng, "trajectory_z")}
    for name, (owner, attr) in marks.items():
        if getattr(vars(owner)[attr], "__module__", None) == faults.__name__:
            return name
    return None


@contextlib.contextmanager
def _rows_swapped():
    from mlqem_tpu_torch.ops import kicked_ising as ki

    gather = ki.gather_rows

    def swapped(x, mesh, n):
        out = gather(x, mesh, n)
        per = -(-n // mesh.size(0))
        out[per:2 * per] = out[:per].clone()
        return out

    ki.gather_rows = swapped
    try:
        yield
    finally:
        ki.gather_rows = gather


def plant(fault, rank: int, world: int):
    """On a rank: the context that plants ``fault`` there, if any."""
    if fault == "rows_swapped":
        return _rows_swapped()
    if fault == "rank_diverges":
        return (faults.plant("answer_altered") if rank == world - 1
                else contextlib.nullcontext())
    if fault is not None:
        return faults.plant(fault)
    return contextlib.nullcontext()


def program_rank(cfg, traffic, device):
    """On a rank: the engine on its share of the mesh; returns call(J, s)
    → (the CRC-32 of its labels' bytes, rank 0's (rows, ideal, noisy) or
    None)."""
    from mlqem_tpu_torch.ops.kicked_ising import KickedIsingEngine
    from mlqem_tpu_torch.parallel.mesh import make_mesh, mesh_device

    mesh = make_mesh(cfg["mesh"]["dp"], cfg["mesh"]["sp"], device=device)
    cal = calibration.line_device(cfg["device"]["num_qubits"],
                                  cfg["device"]["seed"])
    engine = KickedIsingEngine(
        calibration.device_model(cal), nq=cfg["nq"], steps=cfg["steps"],
        device=mesh_device(mesh), dt=cfg["dt"], h=cfg["h"],
        n_traj=traffic["n_traj"], shots=traffic["shots"],
        readout=cfg["readout"])
    rank = dist.get_rank()

    def call(J, s):
        ideal, noisy = engine.generate(J, seed=s, mesh=mesh)
        digest = zlib.crc32(noisy, zlib.crc32(ideal))
        return digest, (slice(None), ideal, noisy) if rank == 0 else None
    return call


def control_rank(cfg, traffic, device):
    """On a rank: the plain reference in TF32 on this rank's share of the
    rows; returns call(J, s) → (None, (rows, ideal, noisy) of the
    share)."""
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if torch.device(device).type == "cuda" else torch.device(device))
    cal = calibration.line_device(cfg["device"]["num_qubits"],
                                  cfg["device"]["seed"])
    spt = max(1, traffic["shots"] // traffic["n_traj"])

    def call(J, s):
        rows = np.array_split(np.arange(len(J)), world)[rank]
        share = J[rows]
        key = (int(s) + 7919 * rank) % 2 ** 63
        gen = torch.Generator(device=dev)
        gen.manual_seed(key)
        cpu = torch.Generator()
        cpu.manual_seed(key)
        ideal = kicked.reference_ideal(cfg, share, dev, **TF32)
        z = kicked.reference_trajectories(cfg, cal, share, traffic["n_traj"],
                                          1, gen, dev, **TF32)
        return None, (slice(rows[0], rows[-1] + 1), ideal.astype(np.float32),
                      shot_mean(z, spt, cpu))
    return call


def serve(inboxes, outbox, work, cfg, traffic, device, fault, J_buf,
          labels):
    """One rank: build ``work``'s call, say so, then answer "call",
    "reset", "peak", "trace" and "spans" until "stop". A call reads its
    couplings from the shared ``J_buf`` and writes the rows it returns into
    the shared ``labels`` [2, batch, nq]; its reply is its digest, or the
    traceback of what it raised."""
    from mlqem_tpu_torch.utils import profiling

    rank, world = dist.get_rank(), dist.get_world_size()
    cuda = torch.device(device).type == "cuda"
    with plant(fault, rank, world):
        call = work(cfg, traffic, device)
        outbox.put((rank, None))
        traced = 0
        while True:
            cmd, arg = inboxes[rank].get(timeout=IDLE_S)
            if cmd == "stop":
                return None
            reply = None
            if cmd == "call":
                try:
                    with (profiling.tracing() if traced > 0
                          else contextlib.nullcontext()):
                        reply, part = call(J_buf.numpy(), arg)
                except Exception:               # noqa: BLE001 (reported)
                    reply = {"error": traceback.format_exc()}
                else:
                    if part is not None:
                        # numpy's copy: torch's copy_ into the shared
                        # tensor took 14-64 ms for these 5.2 MB
                        rows, ideal, noisy = part
                        out = labels.numpy()
                        out[0, rows] = ideal
                        out[1, rows] = noisy
                traced -= 1
            elif cmd == "reset" and cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            elif cmd == "peak":
                reply = torch.cuda.max_memory_allocated() if cuda else 0
            elif cmd == "trace":
                profiling.reset_spans()
                traced = arg
            elif cmd == "spans":
                reply = profiling.span_totals()
            outbox.put((rank, reply))


class Entry:
    """The program: ``generate(mesh=)`` on the ranks."""

    work = staticmethod(program_rank)
    fault = None
    inputs = kicked.Entry.inputs
    check = kicked.Entry.check

    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.cal = calibration.line_device(cfg["device"]["num_qubits"],
                                           cfg["device"]["seed"])
        self.world = cfg["mesh"]["dp"] * cfg["mesh"]["sp"]
        # a call's couplings, and its labels as the ranks return them
        self.J_buf = torch.zeros(traffic["batch"]).share_memory_()
        self.labels = torch.zeros(
            2, traffic["batch"], cfg["nq"]).share_memory_()
        ctx = torch.multiprocessing.get_context("spawn")
        self.inboxes = [ctx.Queue() for _ in range(self.world)]
        self.outbox = ctx.Queue()
        self.failure = None
        self.traced = self.answered = False
        self.older = {p.pid for p in multiprocessing.active_children()}
        self.thread = threading.Thread(
            target=self._serve, args=(self.fault or planted_fault(),),
            daemon=True)
        self.thread.start()
        # ranks left alive by a run that raised end before the interpreter
        # joins them at exit
        atexit.register(self._kill)
        self._wait(START_S)

    def _serve(self, fault):
        from mlqem_tpu_torch.parallel.mesh import spawn

        try:
            spawn(serve, self.world, self.device, self.inboxes, self.outbox,
                  type(self).work, self.cfg, self.traffic, str(self.device),
                  fault, self.J_buf, self.labels)
        except Exception as e:                  # noqa: BLE001 (reported)
            self.outbox.put((-1, f"{type(e).__name__}: {e}"))

    def _kill(self):
        for p in multiprocessing.active_children():
            if p.pid not in self.older:
                p.kill()

    def _stop(self, why: str):
        """Kill every rank and raise: the deployment has failed."""
        self.failure = self.failure or why
        self._kill()
        raise RuntimeError(self.failure)

    def _wait(self, timeout: float) -> dict:
        """Every rank's next reply, by rank, within ``timeout`` s."""
        got, end = {}, time.monotonic() + timeout
        while len(got) < self.world:
            try:
                rank, reply = self.outbox.get(
                    timeout=max(0.0, end - time.monotonic()))
            except queue.Empty:
                self._stop(f"ranks {sorted(set(range(self.world)) - set(got))}"
                           f" gave no answer within {timeout:.0f} s")
            if rank < 0:
                self._stop(f"the ranks failed: {reply}")
            got[rank] = reply
        return got

    def _ask(self, cmd, arg=None, timeout=CALL_S) -> dict:
        """Every rank's reply to ``cmd``, by rank."""
        if self.failure:
            raise RuntimeError(self.failure)
        for q in self.inboxes:
            q.put((cmd, arg))
        return self._wait(timeout)

    def _call(self, J, s) -> dict:
        self.J_buf.numpy()[:] = J
        replies = self._ask("call", s, CALL_S if self.answered else START_S)
        self.answered = True
        errors = {r: e["error"] for r, e in replies.items()
                  if isinstance(e, dict)}
        if errors:
            raise RuntimeError(f"ranks {sorted(errors)} failed the call:\n"
                               + errors[min(errors)])
        return replies

    def warm(self):
        self._call(*self.inputs(-1))
        self._ask("reset")

    def call(self, inputs):
        J, s = inputs
        return len(J), self.merge(J, self._call(J, s))

    def merge(self, J, digests):
        """(J, ideal, noisy) of the whole batch, as the ranks wrote it."""
        if len(set(digests.values())) > 1:
            raise RuntimeError(f"the ranks' labels differ: {digests}")
        ideal, noisy = self.labels.numpy().copy()
        if self.device.type == "cuda":
            for labels in (ideal, noisy):
                torch.as_tensor(labels, device=self.device)
        return J, ideal, noisy

    def spans(self, spans):
        self._ask("trace", self.traffic.get("trace_calls", 1))
        self.traced = True

    def device_peaks(self):
        return {r: int(b) for r, b in self._ask("peak").items()}

    def release(self):
        if self.failure:
            return
        if self.traced:
            from mlqem_tpu_torch.utils import profiling

            totals = self._ask("spans")
            fold = getattr(profiling, "fold_spans", None)
            if fold is not None:
                for r in sorted(totals):
                    fold(totals[r], f"mesh.rank{r}/")
        for q in self.inboxes:
            q.put(("stop", None))
        self.thread.join(timeout=CALL_S)
        if self.thread.is_alive():
            print(f"the ranks did not stop within {CALL_S:.0f} s: killed",
                  file=sys.stderr)
            self._kill()
        atexit.unregister(self._kill)


class Control(Entry):
    """The plain reference in TF32 on the same ranks, each its share."""

    work = staticmethod(control_rank)


def with_fault(name: str):
    """The program's entry with ``name`` (``faults.FAULTS`` or
    ``EXCHANGE_FAULTS``) planted in every rank."""
    if name not in faults.FAULTS + EXCHANGE_FAULTS:
        raise KeyError(f"unknown fault {name!r}")
    return type(f"Entry_{name}", (Entry,), {"fault": name})
