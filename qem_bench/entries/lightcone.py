"""``LightconeIsing.generate_stepwise``: one (circuit, observable) of
demo1, per-step noisy ⟨Z_q⟩ through every depth (with the ideal arm where
the traffic asks for it). Calls cycle through the configuration's
observables; each group of as many calls is one circuit (one J)."""
from __future__ import annotations

import numpy as np
import torch

from .. import calibration, check
from ..reference import noise as ref_noise
from ..reference import sim
from . import TF32, call_rng, shot_mean


def window(q, radius, nq):
    """The chain's qubits within ``radius`` of q: (start, width)."""
    lo, hi = max(q - radius, 0), min(q + radius, nq - 1)
    return lo, hi - lo + 1


def reference_ideal(cfg, J, q, device, dtype=torch.float64, tf32=False):
    """Noise-free ⟨Z_q⟩ after each step [steps], simulated on q's light cone
    of radius ``steps`` (clamped to the chain, as the program's)."""
    nq, steps = cfg["nq"], cfg["steps"]
    w = min(2 * steps + 1, nq)
    start = min(max(q - steps, 0), nq - w)
    bonds, _ = ref_noise.window_bonds(start, w, nq)
    tj = torch.tensor([-2.0 * cfg["dt"] * float(J)], dtype=torch.float64,
                      device=device)
    z = sim.trotter_z(w, bonds, tj, 2.0 * cfg["h"] * cfg["dt"], steps,
                      [q - start], dtype=dtype, tf32=tf32)
    return z[:, 0, 0].double().cpu().numpy()


def reference_trajectories(cfg, cal, J, q, steps, n_traj, fold, gen, device,
                           dtype=torch.float64, tf32=False):
    """Per-trajectory physical ⟨Z_q⟩ (before readout) after each of the
    first ``steps`` steps [steps, n_traj], on the qubits within steps + 1
    of q: wide enough that every bond whose noise reaches Z_q by then is in
    it."""
    nq = cfg["nq"]
    start, w = window(q, steps + 1, nq)
    bonds, glob = ref_noise.window_bonds(start, w, nq)
    probs = [ref_noise.cx_pauli_probs(cal, a, a + 1, cfg["noise_scale"])
             for a in glob]
    tj = torch.full((n_traj,), -2.0 * cfg["dt"] * float(J),
                    dtype=torch.float64, device=device)
    z = sim.trotter_z(w, bonds, tj, 2.0 * cfg["h"] * cfg["dt"], steps,
                      [q - start], probs, fold, gen, dtype=dtype, tf32=tf32)
    return z[:, :, 0].double().cpu().numpy()


class Entry:
    def __init__(self, cfg, traffic, seed, device):
        from mlqem_tpu_torch.device.noise import NoiseModel
        from mlqem_tpu_torch.ops.lightcone import LightconeIsing

        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.cal = calibration.line_device(cfg["device"]["num_qubits"],
                                           cfg["device"]["seed"])
        dm = calibration.device_model(self.cal)
        self.engine = LightconeIsing(
            dm, nq=cfg["nq"], steps=cfg["steps"], device=self.device,
            dt=cfg["dt"], h=cfg["h"], n_traj=traffic["n_traj"],
            shots=traffic["shots"],
            noise_model=NoiseModel.from_device(dm, scale=cfg["noise_scale"]),
            t_chunk=min(cfg["t_chunk"], traffic["n_traj"]))

    def inputs(self, i):
        qs = self.cfg["qubits"]
        J = call_rng(self.seed, 3, i // len(qs)).uniform(
            self.traffic["J_low"], self.traffic["J_high"])
        return (np.float32(J), qs[i % len(qs)],
                int(call_rng(self.seed, 4, i).integers(2 ** 62)))

    def warm(self):
        """One call of each window parity: each keeps its own sign tables."""
        seen = set()
        for k, q in enumerate(self.cfg["qubits"]):
            start = self.engine.window_tables(q)["start"]
            if start % 2 not in seen:
                seen.add(start % 2)
                J, _, s = self.inputs(-1 - k)
                self.call((J, q, s))

    def call(self, inputs):
        J, q, s = inputs
        t = self.traffic
        noisy, ideal = self.engine.generate_stepwise(
            np.array([J], np.float32), t["noise_factor"], [q], seed=s,
            want_ideal=t["want_ideal"], readout_correct=True)
        return 1.0 / len(self.cfg["qubits"]), (J, q, noisy[0, :, 0],
                                               None if ideal is None
                                               else ideal[0, :, 0])

    def spans(self, spans):
        from mlqem_tpu_torch.ops import lightcone

        from ..yardstick import window_evolve_work
        steps = self.cfg["steps"]

        def evolve_work(args, kwargs):
            tw, rows = args[0], args[1].shape[0]
            return window_evolve_work(rows, tw["w"], len(tw["bonds"]), steps)

        eng = self.engine
        for attr in ("window_tables", "run_noisy", "frame_signs"):
            spans.wrap(eng, attr, attr)
        spans.wrap(eng, "evolve_stepwise", "evolve_stepwise", evolve_work)
        spans.wrap(lightcone.sampling, "sample_small_categorical",
                   "sample_small_categorical")

    def release(self):
        del self.engine

    def check(self, outputs, rng):
        cfg, t, chk = self.cfg, self.traffic, self.traffic["check"]
        out = {}
        if t["want_ideal"]:
            out["ideal_max_err"] = max(
                check.ideal_max_err(o[3], reference_ideal(cfg, o[0], o[1],
                                                          self.device))
                for o in outputs)
        k = chk["noisy_steps"]
        picks = rng.choice(len(outputs), min(chk["noisy_calls"],
                                             len(outputs)), replace=False)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(rng.integers(2 ** 62)))
        prog, mean, vp, vr = [], [], [], []
        for p in picks:
            J, q, noisy, _ = outputs[p]
            a = ref_noise.readout_scale(self.cal, q, cfg["noise_scale"])
            z = reference_trajectories(cfg, self.cal, J, q, k,
                                       chk["ref_traj"], t["noise_factor"],
                                       gen, self.device)
            m, var, msq = check.moments(a * z, 1)
            # TREX divides the read-out estimate by a
            prog.append(noisy[:k])
            mean.append(m / a)
            vp.append((var + (1.0 - msq) / t["shots"]) / t["n_traj"] / a ** 2)
            vr.append(var / chk["ref_traj"] / a ** 2)
        out.update(check.noisy_numbers(prog, mean, vp, vr))
        return out


class Control(Entry):
    """Noisy labels only where the check reads them (the first
    ``noisy_steps`` steps, on the cone that decides them); later steps 0."""

    def call(self, inputs):
        J, q, s = inputs
        c, t = self.cfg, self.traffic
        k = t["check"]["noisy_steps"]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(s)
        cpu = torch.Generator()
        cpu.manual_seed(s)
        a = ref_noise.readout_scale(self.cal, q, c["noise_scale"])
        z = reference_trajectories(c, self.cal, J, q, k, t["n_traj"],
                                   t["noise_factor"], gen, self.device,
                                   **TF32)
        noisy = np.zeros(c["steps"], np.float32)
        noisy[:k] = shot_mean((a * z)[..., None], t["shots"], cpu)[:, 0] / a
        ideal = (reference_ideal(c, J, q, self.device, **TF32)
                 if t["want_ideal"] else None)
        return 1.0 / len(c["qubits"]), (J, q, noisy, ideal)
