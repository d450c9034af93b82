"""Tutorial a3: the mesh.

Runner of ``docs/tutorials/a3_multichip_sharding.py``: the label pipeline
with its batch sharded over the mesh's dp ranks, and a 6-qubit
statevector with its amplitudes sharded over sp ranks. ``device="cuda"``
runs one NCCL rank a card; ``"cpu"`` runs 4 gloo ranks on the host.
"""
import numpy as np
import torch

from ..parallel.mesh import spawn
from . import run


def _rank(device, n_ranks, sp):
    from ..circuits.circuit import tensorize
    from ..circuits.families import IsingModel, IsingOptions
    from ..device.registry import get_device
    from ..ops.sharded_sv import (sharded_statevector_fn,
                                  sharded_z_expectations)
    from ..parallel.datagen import IsingLabelPipeline
    from ..parallel.mesh import make_mesh, mesh_device

    # data-parallel label generation: the batch rides the dp ranks
    mesh = make_mesh(device=device)
    pipe = IsingLabelPipeline(get_device("fake_lima"), nq=4, steps=2,
                              dt=0.5, shots=10000,
                              device=mesh_device(mesh))
    ideal, _ = pipe.generate(np.linspace(0.1, 0.5, 32), seed=0, mesh=mesh)
    # amplitude-sharded statevector: the 2^n state spans the sp ranks
    sp_mesh = make_mesh(dp=n_ranks // sp, sp=sp, device=device)
    qc = IsingModel.make_circuit(IsingOptions(nq=6, h=1.0, J=0.3, dt=0.5,
                                              depth=2), measure=False)
    fn = sharded_statevector_fn(qc, sp_mesh, device=device)
    z = sharded_z_expectations(fn(tensorize(qc).params), 6, sp_mesh)
    return ideal.shape, z


def main(device="cuda", fast=False):
    device = torch.device(device)
    n_ranks = torch.cuda.device_count() if device.type == "cuda" else 4
    sp = 4 if n_ranks % 4 == 0 else 1
    print(f"ranks: {n_ranks} ({device.type}), sp = {sp}")
    shape, z = spawn(_rank, n_ranks, device.type, device.type, n_ranks, sp)
    print("dp-sharded labels:", shape)
    print("sharded <Z_q>:", np.round(z, 4))


if __name__ == "__main__":
    from mlqem_tpu_torch.tutorials import a3_multichip_sharding

    run(a3_multichip_sharding.main)
