"""One module a program entry that traffic can drive, named by a traffic
file's ``"entry"``. Each has an ``Entry(config, traffic, seed, device)``:
its constructor is the set-up; ``warm()`` runs each shape the traffic uses
once; ``inputs(i)`` makes call i's inputs from the seed, ``call(inputs)``
makes the call (ending in a host copy) and returns (units, output);
``spans(spans)`` wraps the layers it enters; ``release()`` drops the
program's state; ``check(outputs, rng)`` returns the numbers compared.

An entry whose work runs in processes of its own (ranks on several cards)
keeps them alive from its constructor until ``release()``: the harness
reads the cards after the window and before ``release()``, and counts a
device as used where the run holds memory on it (``cards.py``). Such an
entry also has ``device_peaks()``, returning
``{device index: peak allocated bytes over the window}`` as its ranks read
them: each resets its peak (``torch.cuda.reset_peak_memory_stats``) as
``warm()`` ends and reads ``max_memory_allocated()`` when asked. The
line's ``memory_peak_bytes`` is then the largest; without the hook it is
the harness's own ``max_memory_allocated()``.

A ``Control(Entry)`` beside it makes the same calls' labels from the plain
reference in TF32: the control of the correctness check, which has to come
out not correct.
"""
import numpy as np
import torch

# the control's precision: float32 states, rotations' matmuls in TF32
TF32 = dict(dtype=torch.float32, tf32=True)


def call_rng(seed: int, *keys: int) -> np.random.Generator:
    """The generator of one call's inputs: the run's seed and the call's
    keys, so every seed draws the same sizes and a call repeats exactly."""
    return np.random.default_rng([int(k) % 2 ** 63 for k in (seed, *keys)])


def shot_mean(z, shots: int, generator: torch.Generator) -> np.ndarray:
    """Each trajectory's ⟨Z⟩ in z [..., n_traj, k] read by ``shots``
    binomial shots, averaged over the trajectories: [..., k]."""
    t = torch.as_tensor(np.asarray(z), dtype=torch.float32)
    p1 = ((1.0 - t) / 2.0).clamp(0.0, 1.0)
    counts = torch.binomial(torch.full_like(p1, float(shots)), p1,
                            generator=generator)
    return (1.0 - 2.0 * counts / shots).mean(dim=-2).numpy()
