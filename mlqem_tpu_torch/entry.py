"""The flagship model's forward step, and the multi-rank dry run.

:func:`entry` is the counterpart of ``__graft_entry__.py::entry``: the
paper's GNN (``ExpValCircuitGraphModel3``, hidden 15) on a padded
circuit-graph batch (B 8, N 32, F 22, K 4) with the same inputs, drawn
from ``np.random.default_rng(0)`` in the same order. The weights are a
``state_dict`` argument of ``fn``, as the flax ``variables`` are there, so
a state converted from flax (``convert.state_dict_from_flax``) runs in
their place.

:func:`dryrun_multichip` is the counterpart of
``__graft_entry__.py::dryrun_multichip``: the framework's two parallel
axes on n ranks of a :func:`~.parallel.mesh.make_mesh` mesh, each held
against its one-rank counterpart: (1) a data-parallel training step of
the paper's GNN, (2) both label generators sharded over dp, (3) the
amplitude-sharded statevector over sp.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from .circuits.circuit import tensorize
from .circuits.families import IsingModel, IsingOptions
from .device.registry import get_device
from .models.gnn import ExpValCircuitGraphModel3, edge_index_to_adj
from .models.mlp import Dropout, init_params, shard_batch_layers
from .ops.kicked_ising import KickedIsingEngine
from .ops.sharded_sv import (gather_state, sharded_statevector_fn,
                             sharded_z_expectations)
from .ops.statevector import probabilities, statevector, z_expectations
from .parallel.datagen import IsingLabelPipeline
from .parallel.mesh import make_mesh, mesh_device, shard_rows, spawn

Device = Union[str, torch.device]


def entry(device: Union[str, torch.device] = "cuda"
          ) -> Tuple[Callable, tuple]:
    """(fn, example_args): ``fn(state_dict, noisy, observable, depth, x,
    adj, node_mask)`` is the model's eval-mode forward [B, K] on
    ``device``; ``example_args`` are the model's own weights (initialised
    from seed 0) and the inputs, on ``device``."""
    device = torch.device(device)
    B, N, F, K = 8, 32, 22, 4
    model = ExpValCircuitGraphModel3(hidden_channels=15, exp_value_size=K,
                                     num_node_features=F)
    init_params(model, torch.Generator().manual_seed(0))
    model.to(device).eval()
    rng = np.random.default_rng(0)

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    noisy = dev(rng.uniform(-1, 1, (B, K)))
    observable = dev(rng.normal(size=(B, 1, 17)))
    depth = dev(rng.uniform(1, 9, (B,)))
    x = dev(rng.normal(size=(B, N, F)))
    adj = torch.zeros((B, N, N), dtype=torch.float32, device=device)
    idx = torch.arange(N - 1, device=device)
    adj[:, idx + 1, idx] = 1.0
    node_mask = torch.ones((B, N), dtype=torch.bool, device=device)
    state: Dict[str, torch.Tensor] = dict(model.state_dict())

    def fn(state_dict, noisy, observable, depth, x, adj, node_mask):
        with torch.no_grad():
            return torch.func.functional_call(
                model, state_dict,
                (noisy, observable, depth, x, adj, node_mask))

    return fn, (state, noisy, observable, depth, x, adj, node_mask)


# --------------------------------------------------------------------------
# The multi-rank dry run
# --------------------------------------------------------------------------
def dryrun_batch(n_devices: int) -> Dict[str, np.ndarray]:
    """The dry run's training batch (B = 2·n_devices, N 16, F 22, K 4),
    drawn from ``np.random.default_rng(0)`` as the JAX package's is."""
    B, N, F, K = 2 * n_devices, 16, 22, 4
    rng = np.random.default_rng(0)
    batch = {
        "noisy": rng.uniform(-1, 1, (B, K)).astype(np.float32),
        "observable": rng.normal(size=(B, 1, 17)).astype(np.float32),
        "depth": rng.uniform(1, 5, (B,)).astype(np.float32),
        "x": rng.normal(size=(B, N, F)).astype(np.float32),
        "edge_index": np.zeros((B, 2, N), np.int32),
        "edge_mask": np.ones((B, N), bool),
        "node_mask": np.ones((B, N), bool),
        "y": rng.uniform(-1, 1, (B, K)).astype(np.float32),
    }
    for i in range(N - 1):
        batch["edge_index"][:, 0, i] = i
        batch["edge_index"][:, 1, i] = i + 1
    return batch


def dryrun_model() -> ExpValCircuitGraphModel3:
    """The dry run's model: the paper's GNN at hidden 5, K 4, F 22."""
    return ExpValCircuitGraphModel3(hidden_channels=5, exp_value_size=4,
                                    num_node_features=22)


def dp_train_step(model: torch.nn.Module, batch: Dict[str, np.ndarray],
                  mesh=None, learning_rate: float = 1e-3, seed: int = 1
                  ) -> Tuple[float, Dict[str, np.ndarray]]:
    """One Adam step of the MSE loss on ``batch``, in place on ``model``
    (on its device); returns (loss, gradients).

    With ``mesh`` each dp rank takes its rows (:func:`~.parallel.mesh.
    shard_rows`), the BatchNorm statistics and dropout masks are those of
    the whole batch (:func:`~.models.mlp.shard_batch_layers`), and the
    gradients and the loss are averaged over dp, so the step equals the
    one-rank step on the whole batch. Dropout draws from a generator
    seeded with ``seed``.
    """
    device = next(model.parameters()).device
    n = len(batch["y"])
    rows = torch.arange(n)
    group = None
    if mesh is not None:
        dp = mesh.size(0)
        if n % dp:
            raise ValueError(f"a batch of {n} rows does not split over "
                             f"{dp} dp ranks")
        rows, group = shard_rows(n, mesh), mesh.get_group("dp")
    shard_batch_layers(model, group, n, rows.to(device))
    gen = torch.Generator(device=device).manual_seed(seed)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = gen
    b = {k: torch.as_tensor(v[rows.numpy()], device=device)
         for k, v in batch.items()}
    adj = edge_index_to_adj(b["edge_index"], b["edge_mask"],
                            b["x"].shape[1])
    optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate,
                                 eps=1e-8)
    model.train()
    optimizer.zero_grad(set_to_none=True)
    loss = torch.mean((model(b["noisy"], b["observable"], b["depth"],
                             b["x"], adj, b["node_mask"]) - b["y"]) ** 2)
    loss.backward()
    loss = loss.detach()
    if group is not None:
        for p in [loss] + [p.grad for p in model.parameters()
                           if p.grad is not None]:
            dist.all_reduce(p, group=group)
            p /= mesh.size(0)
    grads = {name: p.grad.cpu().numpy().copy()
             for name, p in model.named_parameters() if p.grad is not None}
    optimizer.step()
    shard_batch_layers(model, None, n, rows)
    return float(loss), grads


def mesh_label_runs(jobs: Sequence[tuple], dp: Optional[int] = None,
                    sp: int = 1, device: Device = "cuda") -> List[tuple]:
    """On this rank: each job's generator unsharded, on a (dp, sp) mesh,
    then unsharded again, on one engine.

    ``jobs``: (engine class, device model, constructor kwargs, J values,
    seed); the engine is built on this rank's device. Returns, per job,
    the three (ideal, noisy) numpy pairs.
    """
    mesh = make_mesh(dp, sp, device=device)
    out = []
    for cls, device_model, kwargs, J, seed in jobs:
        eng = cls(device_model, device=mesh_device(mesh), **kwargs)
        out.append((eng.generate(J, seed=seed),
                    eng.generate(J, seed=seed, mesh=mesh),
                    eng.generate(J, seed=seed)))
    return out


def sharded_sv_runs(jobs: Sequence[tuple], device: Device = "cuda"
                    ) -> List[List[tuple]]:
    """On this rank: each job's amplitude-sharded statevector.

    ``jobs``: (circuit, sp, list of params [L, 3]); one structure serves
    each job's params. Returns, per job and params, the whole state
    (:func:`~.ops.sharded_sv.gather_state`) and the per-qubit ⟨Z⟩
    (:func:`~.ops.sharded_sv.sharded_z_expectations`) as numpy.
    """
    out = []
    for circuit, sp, params_list in jobs:
        mesh = make_mesh(dist.get_world_size() // sp, sp, device=device)
        fn = sharded_statevector_fn(circuit, mesh, device=device)
        runs = []
        for params in params_list:
            local = fn(params)
            runs.append((gather_state(local, mesh).cpu().numpy(),
                         sharded_z_expectations(local, circuit.num_qubits,
                                                mesh)))
        out.append(runs)
    return out


def _dryrun_jobs(n_devices: int):
    """The dry run's label jobs and statevector job."""
    dev = get_device("fake_lima")
    J = np.linspace(0.1, 0.5, 2 * n_devices).astype(np.float32)
    labels = [(IsingLabelPipeline, dev,
               dict(nq=4, steps=1, shots=128, dt=0.5), J, 0),
              (KickedIsingEngine, dev,
               dict(nq=4, steps=2, dt=0.5, n_traj=8, shots=None), J, 0)]
    sp = 1
    while sp < 8 and n_devices % (2 * sp) == 0:
        sp *= 2
    nq = max(5, int(np.log2(sp)) + 2)
    qc = IsingModel.make_circuit(IsingOptions(nq=nq, h=1.0, J=0.3, dt=0.5,
                                              depth=2), measure=False)
    return labels, (qc, sp, [tensorize(qc).params])


def _dryrun_rank(n_devices: int, device: str,
                 state: Dict[str, np.ndarray]) -> Dict:
    """One rank of :func:`dryrun_multichip`."""
    mesh = make_mesh(dp=n_devices, sp=1, device=device)
    model = dryrun_model()
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    model.to(mesh_device(mesh))
    loss, grads = dp_train_step(model, dryrun_batch(n_devices), mesh)
    labels, sv_job = _dryrun_jobs(n_devices)
    return {"loss": loss, "grads": grads,
            "state": {k: v.cpu().numpy()
                      for k, v in model.state_dict().items()},
            "labels": mesh_label_runs(labels, dp=n_devices, device=device),
            "sv": sharded_sv_runs([sv_job], device=device)[0][0]}


def dryrun_multichip(n_devices: int, device: Device = "cuda",
                     state_dict: Optional[Dict[str, torch.Tensor]] = None
                     ) -> Dict:
    """Run the sharded training and data paths on ``n_devices`` ranks and
    hold each against its one-rank counterpart.

    ``device="cpu"`` spawns gloo ranks (the JAX package's virtual CPU
    mesh); ``"cuda"`` spawns NCCL ranks, one a card, and needs
    ``n_devices`` cards. ``state_dict``: the GNN's starting weights (by
    default its init from seed 0; a flax state converts with
    ``convert.state_dict_from_flax``). Raises if a part disagrees; returns
    the report (rank 0's results, the one-rank references and the
    largest differences).

    1. dp: one Adam step of the paper's GNN on a batch sharded over the
       ranks (BatchNorm statistics and dropout masks of the whole batch,
       gradients averaged) against the one-rank step: gradients,
       statistics and loss ≤ 1e-5, and the weights ≤ 1e-5 where |g| >
       1e-6 (elsewhere Adam's first step lr·g/(|g| + 1e-8) is decided
       by rounding: ≤ 2·lr);
    2. dp: ``IsingLabelPipeline`` (density matrix, 128 shots) and
       ``KickedIsingEngine`` sharded, between two unsharded calls on the
       same engine: all equal ≤ 1e-6;
    3. sp: the amplitude-sharded statevector of a depth-2 Ising circuit
       against the single-device one: ⟨Z_q⟩ ≤ 1e-4 (the JAX package's
       bound), the state ≤ 1e-5.
    """
    device = torch.device(device)
    if device.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"dryrun_multichip({n_devices}) needs "
                         f"{n_devices} cards; "
                         f"{torch.cuda.device_count()} visible")
    ref_device = torch.device("cuda", 0) if device.type == "cuda" \
        else device
    model = dryrun_model()
    if state_dict is None:
        init_params(model, torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(state_dict)
    state = {k: v.cpu().numpy() for k, v in model.state_dict().items()}
    rep = spawn(_dryrun_rank, n_devices, device.type, n_devices,
                device.type, state)

    # 1. the one-rank step on the whole batch
    model.to(ref_device)
    loss, grads = dp_train_step(model, dryrun_batch(n_devices))
    ref_state = {k: v.cpu().numpy() for k, v in model.state_dict().items()}
    params = dict(model.named_parameters())
    small = {k: np.abs(g) <= 1e-6 for k, g in grads.items()}
    err = {"loss": abs(rep["loss"] - loss),
           "grads": max(float(np.abs(rep["grads"][k] - g).max())
                        for k, g in grads.items()),
           "stats": max(float(np.abs(rep["state"][k] - v).max())
                        for k, v in ref_state.items() if k not in params),
           "weights": max(float(np.abs(rep["state"][k] - v)[
               ~small[k]].max(initial=0.0))
               for k, v in ref_state.items() if k in params),
           "weights_small_grad": max(float(np.abs(rep["state"][k] - v)[
               small[k]].max(initial=0.0))
               for k, v in ref_state.items() if k in params)}
    # 2. the label generators: unsharded, sharded, unsharded
    err["labels"] = max(float(np.abs(a - b).max())
                        for runs in rep["labels"]
                        for pair in (runs[1], runs[2])
                        for a, b in zip(runs[0], pair))
    # 3. the sharded statevector against the single-device one
    _, (qc, sp, _) = _dryrun_jobs(n_devices)
    psi_ref = statevector(tensorize(qc), device=ref_device)
    z_ref = z_expectations(probabilities(psi_ref),
                           qc.num_qubits).cpu().numpy()
    psi, z = rep["sv"]
    err["sv_state"] = float(np.abs(psi - psi_ref.cpu().numpy()).max())
    err["sv_z"] = float(np.abs(z - z_ref).max())
    bounds = {"loss": 1e-5, "grads": 1e-5, "stats": 1e-5, "weights": 1e-5,
              "weights_small_grad": 2e-3, "labels": 1e-6, "sv_state": 1e-5,
              "sv_z": 1e-4}
    bad = {k: v for k, v in err.items() if not v <= bounds[k]}
    if bad or not np.isfinite(rep["loss"]):
        raise RuntimeError(f"dryrun_multichip({n_devices}) on "
                           f"{device.type}: {bad} exceed {bounds}")
    ideal = rep["labels"][0][1][0]
    print(f"dryrun_multichip({n_devices}) on {n_devices} {device.type} "
          f"ranks: training step loss {rep['loss']:.4f} (one-rank step "
          f"max|Δ| gradients {err['grads']:.2e}, weights "
          f"{err['weights']:.2e}); datagen batch {ideal.shape} (sharded vs "
          f"unsharded max|Δ| {err['labels']:.2e}); sharded-sv (sp={sp}, "
          f"{qc.num_qubits} qubits) max|Δz| {err['sv_z']:.2e} — all OK")
    return {**rep, "errors": err, "sp": sp,
            "reference": {"loss": loss, "grads": grads, "state": ref_state}}
