"""The cards' own account of the devices a run used.

Each of a cell's ``chips`` visible CUDA devices counts as used when its
free memory, as CUDA reports it (``torch.cuda.mem_get_info``), has
fallen since the ``Cards`` were made, before set-up, or the harness's own
allocator holds memory there. A machine runs one benchmark process, with
the ranks it starts, a card, so what has fallen is the run's: its ranks'
contexts and allocations, or the harness's.

NVML's list of the processes on a card is not the source: where the run
lives in a PID namespace of its own (a container), NVML names its
processes by ids of another namespace, which match none of the run's.

Nothing here runs during the timed window: the harness reads the cards
after it, while the entry still holds its state.
"""
from __future__ import annotations

from typing import Dict

# a smaller fall is no use of the card
MIN_BYTES = 2 ** 20


class Cards:
    """The first ``chips`` visible CUDA devices, as CUDA reports them."""

    source = "cudaMemGetInfo"

    def __init__(self, chips: int):
        import torch

        self.chips = chips
        # the harness's context on each device is made here, inside
        # ``free0``: only what comes after it counts
        self.free0 = [torch.cuda.mem_get_info(d)[0] for d in range(chips)]

    def kind(self, d: int) -> str:
        import torch

        return torch.cuda.get_device_name(d)

    def used(self) -> Dict[int, int]:
        """{device index: bytes} for each of the ``chips`` devices on which
        the run holds memory: the fall in its free memory since set-up, or
        the harness's own reserve there, whichever is larger."""
        import torch

        held = {}
        for d in range(self.chips):
            n = max(self.free0[d] - torch.cuda.mem_get_info(d)[0],
                    torch.cuda.memory_reserved(d))
            if n >= MIN_BYTES:
                held[d] = n
        return held
