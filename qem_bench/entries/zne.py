"""``workflows.zne_scale.zne_sweep_ising``: one ZNE sweep (ideal, noisy at
each noise factor, and the extrapolated value of every circuit)."""
from __future__ import annotations

import numpy as np
import torch

from .. import calibration, check
from . import TF32, call_rng, shot_mean
from .kicked import (program_var, reference_ideal, reference_trajectories,
                     wrap_stages)


class Entry:
    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.cal = calibration.line_device(cfg["device"]["num_qubits"],
                                           cfg["device"]["seed"])
        self.dm = calibration.device_model(self.cal)
        self.J = np.linspace(traffic["J_low"], traffic["J_high"],
                             traffic["circuits"]).astype(np.float32)

    def inputs(self, i):
        return int(call_rng(self.seed, 2, i).integers(2 ** 62))

    def warm(self):
        self.call(self.inputs(-1))

    def call(self, s):
        from mlqem_tpu_torch.workflows.zne_scale import zne_sweep_ising

        c, t = self.cfg, self.traffic
        out = zne_sweep_ising(self.dm, nq=c["nq"], steps=c["steps"],
                              J_values=self.J, dt=c["dt"], h=c["h"],
                              noise_factors=tuple(t["noise_factors"]),
                              n_traj=t["n_traj"], shots=t["shots"], seed=s,
                              device=self.device)
        nf = t["noise_factors"]
        return len(self.J), (out["ideal"], out["measured"][nf[0]],
                             out["measured"][nf[1]], out["zne"])

    def spans(self, spans):
        from mlqem_tpu_torch.ops.kicked_ising import KickedIsingEngine

        wrap_stages(spans)
        spans.wrap(KickedIsingEngine, "generate", "generate")

    def release(self):
        pass

    def check(self, outputs, rng):
        t, chk = self.traffic, self.traffic["check"]
        ideal = reference_ideal(self.cfg, self.J, self.device)
        err = max(check.ideal_max_err(o[0], ideal) for o in outputs)
        (f1, f3), n = t["noise_factors"], chk["ref_traj"]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(rng.integers(2 ** 62)))
        m = {}
        for f in (f1, f3):
            z = reference_trajectories(self.cfg, self.cal, self.J, n, f, gen,
                                       self.device)
            mean, var, msq = check.moments(z, 1)
            m[f] = (mean, program_var(var, msq, t["n_traj"], t["shots"]),
                    var / n)
        # the linear fit through (f1, f3), read at 0
        c1, c3 = f3 / (f3 - f1), -f1 / (f3 - f1)
        want = [m[f1], m[f3],
                (c1 * m[f1][0] + c3 * m[f3][0],
                 c1 ** 2 * m[f1][1] + c3 ** 2 * m[f3][1],
                 c1 ** 2 * m[f1][2] + c3 ** 2 * m[f3][2])]
        picks = rng.choice(len(outputs), min(chk["noisy_calls"],
                                             len(outputs)), replace=False)
        prog = np.stack([np.stack(outputs[k][1:]) for k in picks])
        mean, vp, vr = (np.broadcast_to(np.stack([w[j] for w in want]),
                                        prog.shape) for j in range(3))
        mask = np.zeros(prog.shape, bool)
        mask[:, :2] = True
        out = {"ideal_max_err": err}
        out.update(check.noisy_numbers(prog, mean, vp, vr, mask))
        return out


class Control(Entry):
    def call(self, s):
        c, t = self.cfg, self.traffic
        gen = torch.Generator(device=self.device)
        gen.manual_seed(s)
        cpu = torch.Generator()
        cpu.manual_seed(s)
        ideal = reference_ideal(c, self.J, self.device, **TF32)
        f1, f3 = t["noise_factors"]
        spt = max(1, t["shots"] // t["n_traj"])
        n1, n3 = (shot_mean(reference_trajectories(
            c, self.cal, self.J, t["n_traj"], f, gen, self.device, **TF32),
            spt, cpu) for f in (f1, f3))
        return len(self.J), (ideal, n1, n3, (f3 * n1 - f1 * n3) / (f3 - f1))
