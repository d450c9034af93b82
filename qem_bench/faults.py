"""Faults planted in the program under the timed path, for the check of
the check: each has to turn ``correct`` false in a run of the cells where
it can occur. ``plant(name)`` is a context manager that patches the
program's functions and restores them.

- ``step_unchanged``: one Trotter step returns its state unchanged (the
  last step of each evolution).
- ``half_batch``: half of the trajectories are left out and the label is
  the mean over the rest.
- ``answer_altered``: one ideal label of each call is altered by 1e-3
  where it is produced (where a call has no ideal arm, one noisy label
  by 0.5).
- ``readout_dropped``: the readout confusion is left out (a fault of the
  noise, read for the noisy numbers' upper readings).

The exchange between chips is no fault of these one-chip cells.
"""
from __future__ import annotations

import contextlib

import numpy as np

FAULTS = ("step_unchanged", "half_batch", "answer_altered",
          "readout_dropped")


@contextlib.contextmanager
def _patched(pairs):
    saved = [(o, a, o.__dict__[a]) for o, a, _ in pairs]
    try:
        for o, a, f in pairs:
            setattr(o, a, f)
        yield
    finally:
        for o, a, f in saved:
            setattr(o, a, f)


def plant(name: str):
    from mlqem_tpu_torch.ops import kicked_ising as ki
    from mlqem_tpu_torch.ops import lightcone as lc
    from mlqem_tpu_torch.ops.kernels import evolve as k1
    from mlqem_tpu_torch.ops.kernels import fused_step as k3

    Eng, Lc = ki.KickedIsingEngine, lc.LightconeIsing
    if name == "step_unchanged":
        def short(fn):
            def f(re, im, kick, bond, theta, bit_pm, bond_par, th, S, nq, nb):
                return fn(re, im, kick[:, :(S - 1) * nq].contiguous(),
                          bond[:, :(S - 1) * nb].contiguous(), theta, bit_pm,
                          bond_par, th, S - 1, nq, nb)
            return f

        count = [0]

        def skip(fn, steps):
            def f(re, im, *args, **kwargs):
                count[0] += 1
                if count[0] % steps == 0:
                    return re.clone(), im.clone()
                return fn(re, im, *args, **kwargs)
            return f

        def lc_generate(orig):
            def f(self, *args, **kwargs):
                with _patched([
                        (k3, "fused_trotter_step",
                         skip(k3.__dict__["fused_trotter_step"], self.steps)),
                        (k3, "fused_trotter_step_reference",
                         skip(k3.__dict__["fused_trotter_step_reference"],
                              self.steps))]):
                    return orig(self, *args, **kwargs)
            return f

        return _patched([
            (k1, "evolve_fused", short(k1.evolve_fused)),
            (k1, "evolve_fused_reference", short(k1.evolve_fused_reference)),
            (Lc, "generate_stepwise", lc_generate(Lc.generate_stepwise))])
    if name == "half_batch":
        orig_shots, orig_noisy = Eng.shot_labels, Lc.run_noisy

        def shots(self, z, generator):
            return orig_shots(self, z[:, :z.shape[1] // 2].contiguous(),
                              generator)

        def noisy(self, tw, theta_j, *args, **kwargs):
            full = self.t_chunk
            self.t_chunk = max(1, full // 2)
            try:
                return orig_noisy(self, tw, theta_j, *args, **kwargs)
            finally:
                self.t_chunk = full

        return _patched([(Eng, "shot_labels", shots),
                         (Lc, "run_noisy", noisy)])
    if name == "answer_altered":
        orig_gen, orig_sw = Eng.generate, Lc.generate_stepwise

        def gen(self, *args, **kwargs):
            ideal, noisy = orig_gen(self, *args, **kwargs)
            ideal = ideal.copy()
            ideal[0, 0] += np.float32(1e-3)
            return ideal, noisy

        def sw(self, *args, **kwargs):
            noisy, ideal = orig_sw(self, *args, **kwargs)
            if ideal is not None:
                ideal = ideal.copy()
                ideal[0, -1, 0] += np.float32(1e-3)
            else:
                noisy = noisy.copy()
                noisy[0, 0, 0] += np.float32(0.5)
            return noisy, ideal

        return _patched([(Eng, "generate", gen),
                         (Lc, "generate_stepwise", sw)])
    if name == "readout_dropped":
        orig_tz, orig_noisy = Eng.trajectory_z, Lc.run_noisy

        def tz(self, probs, flip):
            conf = self.tables.confusion
            self.tables.confusion = None
            try:
                return orig_tz(self, probs, flip)
            finally:
                self.tables.confusion = conf

        def noisy(self, tw, theta_j, probs, a, b, generator, *args, **kw):
            return orig_noisy(self, tw, theta_j, probs, 1.0, 0.0, generator,
                              *args, **kw)

        return _patched([(Eng, "trajectory_z", tz),
                         (Lc, "run_noisy", noisy)])
    raise KeyError(f"unknown fault {name!r}; known: {FAULTS}")
