"""``KickedIsingEngine.generate``: one batch of (ideal, noisy) ⟨Z_q⟩
labels for couplings J drawn uniformly from the traffic's range."""
from __future__ import annotations

import numpy as np
import torch

from .. import calibration, check
from ..reference import noise as ref_noise
from ..reference import sim
from ..yardstick import kicked_evolve_work
from . import TF32, call_rng, shot_mean


def theta(cfg, J):
    """(θ_J per circuit, θ_h)."""
    return (-2.0 * cfg["dt"] * np.asarray(J, np.float64),
            2.0 * cfg["h"] * cfg["dt"])


def reference_ideal(cfg, J, device, dtype=torch.float64, tf32=False,
                    block=8192):
    """Noise-free ⟨Z_q⟩ [len(J), nq] after the last step."""
    nq = cfg["nq"]
    bonds, _ = ref_noise.window_bonds(0, nq, nq)
    tj, th = theta(cfg, J)
    out = []
    for sl in sim.blocks(len(J), block):
        z = sim.trotter_z(nq, bonds, torch.as_tensor(tj[sl], device=device),
                          th, cfg["steps"], range(nq), dtype=dtype,
                          tf32=tf32)
        out.append(z[-1].double().cpu().numpy())
    return np.concatenate(out)


def reference_trajectories(cfg, cal, J, n_traj, fold, gen, device,
                           dtype=torch.float64, tf32=False, rows=32768):
    """Per-trajectory ⟨Z_q⟩ as read out (readout applied): [len(J), n_traj,
    nq], each trajectory with its own Pauli errors."""
    nq = cfg["nq"]
    bonds, glob = ref_noise.window_bonds(0, nq, nq)
    probs = [ref_noise.cx_pauli_probs(cal, a, a + 1, cfg["noise_scale"])
             for a in glob]
    a = np.array([ref_noise.readout_scale(cal, q, cfg["noise_scale"])
                  if cfg["readout"] else 1.0 for q in range(nq)])
    tj, th = theta(cfg, J)
    tj = np.repeat(tj, n_traj)
    out = []
    for sl in sim.blocks(len(tj), rows):
        z = sim.trotter_z(nq, bonds, torch.as_tensor(tj[sl], device=device),
                          th, cfg["steps"], range(nq), probs, fold, gen,
                          dtype=dtype, tf32=tf32)
        out.append(z[-1].double().cpu().numpy())
    return (np.concatenate(out) * a).reshape(len(J), n_traj, nq)


def program_var(var, msq, n_traj, shots):
    """The variance of the engine's label: n_traj trajectories, each read by
    shots // n_traj binomial shots (shots None: the exact mean of each)."""
    if shots is None:
        return var / n_traj
    spt = max(1, shots // n_traj)
    return (var + (1.0 - msq) / spt) / n_traj


def wrap_stages(spans):
    """Spans on the kicked engine's stages, on its class (the ZNE sweep
    builds its engines inside each call); ``evolve`` records its work."""
    from mlqem_tpu_torch.ops.kicked_ising import KickedIsingEngine

    def evolve_work(args, kwargs):
        eng, rows = args[0], args[2].shape[0]
        return kicked_evolve_work(rows, eng.nq, len(eng.bonds), eng.steps)

    for attr in ("sample_draws", "frame_signs", "trajectory_z",
                 "shot_labels"):
        spans.wrap(KickedIsingEngine, attr, attr)
    spans.wrap(KickedIsingEngine, "evolve", "evolve", evolve_work)


class Entry:
    def __init__(self, cfg, traffic, seed, device):
        from mlqem_tpu_torch.ops.kicked_ising import KickedIsingEngine

        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.cal = calibration.line_device(cfg["device"]["num_qubits"],
                                           cfg["device"]["seed"])
        self.engine = KickedIsingEngine(
            calibration.device_model(self.cal), nq=cfg["nq"],
            steps=cfg["steps"], device=self.device, dt=cfg["dt"], h=cfg["h"],
            n_traj=traffic["n_traj"], shots=traffic["shots"],
            readout=cfg["readout"])

    def inputs(self, i):
        rng = call_rng(self.seed, 1, i)
        J = rng.uniform(self.traffic["J_low"], self.traffic["J_high"],
                        self.traffic["batch"]).astype(np.float32)
        return J, int(rng.integers(2 ** 62))

    def warm(self):
        self.call(self.inputs(-1))

    def call(self, inputs):
        J, s = inputs
        ideal, noisy = self.engine.generate(J, seed=s)
        return len(J), (J, ideal, noisy)

    def spans(self, spans):
        wrap_stages(spans)

    def release(self):
        del self.engine

    def check(self, outputs, rng):
        chk = self.traffic["check"]
        picks = rng.choice(len(outputs), min(chk["ideal_calls"],
                                             len(outputs)), replace=False)
        err = max(check.ideal_max_err(outputs[k][1],
                                      reference_ideal(self.cfg, outputs[k][0],
                                                      self.device))
                  for k in picks)
        # a sample of circuits over every call, for the noisy labels
        calls = rng.integers(len(outputs), size=chk["noisy_circuits"])
        rows = rng.integers(self.traffic["batch"], size=chk["noisy_circuits"])
        J = np.array([outputs[c][0][r] for c, r in zip(calls, rows)])
        noisy = np.stack([outputs[c][2][r] for c, r in zip(calls, rows)])
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(rng.integers(2 ** 62)))
        z = reference_trajectories(self.cfg, self.cal, J, chk["ref_traj"], 1,
                                   gen, self.device)
        mean, var, msq = check.moments(z, 1)
        out = {"ideal_max_err": err}
        out.update(check.noisy_numbers(
            noisy, mean, program_var(var, msq, self.traffic["n_traj"],
                                     self.traffic["shots"]),
            var / chk["ref_traj"]))
        return out


class Control(Entry):
    def call(self, inputs):
        J, s = inputs
        c, t = self.cfg, self.traffic
        gen = torch.Generator(device=self.device)
        gen.manual_seed(s)
        cpu = torch.Generator()
        cpu.manual_seed(s)
        ideal = reference_ideal(c, J, self.device, **TF32)
        z = reference_trajectories(c, self.cal, J, t["n_traj"], 1, gen,
                                   self.device, **TF32)
        spt = max(1, t["shots"] // t["n_traj"])
        return len(J), (J, ideal.astype(np.float32), shot_mean(z, spt, cpu))
