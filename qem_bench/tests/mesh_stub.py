"""A stub entry whose work runs on persistent ranks, one a card, started
by the port's ``mlqem_tpu_torch.parallel.mesh.spawn`` (NCCL on the card,
gloo on the CPU). Each call all-reduces a buffer of ``traffic["numel"]``
float32 over the ranks; the harness's own process allocates nothing. The
ranks live from the constructor until ``release()`` and report their
peaks through ``device_peaks()``, as the entries protocol asks of an
entry on several devices."""
from __future__ import annotations

import threading

import torch
import torch.distributed as dist

WAIT_S = 300.0


def rank_loop(inboxes, outbox, numel, device):
    """One rank: serve "call", "reset", "peak" until "stop"."""
    rank = dist.get_rank()
    cuda = torch.device(device).type == "cuda"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    peak = 0
    while True:
        cmd = inboxes[rank].get()
        if cmd == "stop":
            return None
        if cmd == "reset":
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            peak, reply = 0, None
        elif cmd == "peak":
            reply = torch.cuda.max_memory_allocated(dev) if cuda else peak
        else:
            x = torch.full((numel,), float(rank + 1), device=dev)
            dist.all_reduce(x)
            peak = max(peak, x.numel() * x.element_size())
            reply = (float(x.min()), float(x.max()))
            del x
        outbox.put((rank, reply))


class Entry:
    def __init__(self, config, traffic, seed, device):
        self.world = (torch.cuda.device_count()
                      if torch.device(device).type == "cuda"
                      else traffic["ranks"])
        ctx = torch.multiprocessing.get_context("spawn")
        self.inboxes = [ctx.Queue() for _ in range(self.world)]
        self.outbox = ctx.Queue()
        self.failure = None
        self.thread = threading.Thread(
            target=self._serve, args=(device, traffic["numel"]))
        self.thread.start()

    def _serve(self, device, numel):
        from mlqem_tpu_torch.parallel.mesh import spawn

        try:
            spawn(rank_loop, self.world, device, self.inboxes, self.outbox,
                  numel, device)
        except Exception as e:                  # noqa: BLE001 (reported)
            self.failure = e
            self.outbox.put((-1, None))

    def _ask(self, cmd):
        for q in self.inboxes:
            q.put(cmd)
        got = {}
        while len(got) < self.world:
            rank, reply = self.outbox.get(timeout=WAIT_S)
            if rank < 0:
                raise RuntimeError(f"the ranks failed: {self.failure}")
            got[rank] = reply
        return got

    def warm(self):
        self._ask("call")
        self._ask("reset")

    def inputs(self, i):
        return i

    def call(self, inputs):
        return self.world, self._ask("call")

    def spans(self, spans):
        pass

    def device_peaks(self):
        return self._ask("peak")

    def release(self):
        for q in self.inboxes:
            q.put("stop")
        self.thread.join(timeout=WAIT_S)

    def check(self, outputs, rng):
        want = self.world * (self.world + 1) / 2
        return {"sum_err": max(abs(v - want) for got in outputs
                               for reply in got.values() for v in reply)}
