"""Tutorial a2: 100 qubits.

Runner of ``docs/tutorials/a2_scale_100q.py``: noisy 100-qubit TFIM
⟨Z_q⟩ by Pauli propagation, then the demo1 mimicry pipeline at a reduced
depth.
"""
import numpy as np

from ..device.registry import configurable_device
from ..ops.pauli_prop import PauliPropagatorIsing
from ..workflows.demos import demo1_zne_mimic_100q
from . import run


def main(device="cuda", fast=False):
    nq, K = (20, 512) if fast else (100, 8192)
    dev = configurable_device(nq, seed=0)
    pp = PauliPropagatorIsing(dev, nq=nq, steps=4, dt=0.5, h=0.66 * np.pi,
                              max_terms=K, device=device)
    vals, disc = pp.generate(np.array([0.15], np.float32),
                             qubits=[0, nq // 4, nq // 2, 3 * nq // 4,
                                     nq - 1])
    print(f"{nq}Q noisy <Z>:", np.round(vals[0], 4),
          "| truncation weight:", np.round(disc[0].max(), 4))
    # the demo1 mimicry pipeline at 3 steps (the exact light-cone engine;
    # docs/demos runs the published 10-step depth on it too)
    out = demo1_zne_mimic_100q(dev, nq=nq, num_steps=3, device=device)
    print(f"demo1 ({out['engine']}): rmse noisy {out['rmse_noisy']:.4f} | "
          f"zne {out['rmse_zne']:.4f} | mimic {out['rmse_mimic']:.4f}")


if __name__ == "__main__":
    run(main)
