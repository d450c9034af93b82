"""mlqem_tpu_torch — ML-QEM training-label generators in PyTorch and CUDA.

A port of the JAX package ``mlqem_tpu`` to PyTorch, with its TPU kernels
as hand-written CUDA kernels for Hopper: the kicked-Ising evolution
(``csrc/evolve.cu``), the generic Pauli-frame evolution
(``csrc/frame_evolve.cu``), one Trotter step (``csrc/fused_step.cu``) and
the Walsh–Hadamard transform over device-memory planes (``csrc/wht.cu``),
the last two on the light-cone engine's path; one CUDA kernel has no TPU
kernel behind it: the Pauli-frame pass of the kicked-Ising and light-cone
engines (``csrc/propagate_frames.cu``), a ``lax.scan`` in the JAX package;
the exact density-matrix
engines, the sparse Pauli-propagation engine, the stabilizer tableau, the
Estimator primitives, digital ZNE and the learning stack (datasets, the
paper's GNN, the MLP/linear/forest regressors, the trainer and the
``learning``/``ngem`` Estimators) are plain PyTorch, and so are the
experiment workflows above them (the labelled datasets, the model zoo and
ZNE mimicry, the 20-qubit ZNE sweep, demo1 and demo2, the truncation
audit, transfer learning and calibration drift, the Clifford scalability
sweep and the paper-parity study), and the paper's VQE application on the
learning Estimator (the H2 problem set, ``VQE``, the ansatz dataset, the
forest processor and the H2 dissociation curve). The parallelism layer is
``torch.distributed``: a (dp, sp) ``DeviceMesh`` (``parallel/mesh.py``),
the ``mesh=`` branch of both label generators, the amplitude-sharded
statevector (``ops/sharded_sv.py``) and ``dryrun_multichip``; the
artifact writers with their schema gates (``workflows/artifacts.py``,
``workflows/schemas.py``), the figures and the runners of the JAX
package's tutorial and demo scripts (``tutorials/``) sit on top. It
mirrors the JAX
package's module paths and imports neither JAX nor ``mlqem_tpu``. Every
entry point runs on ``device="cuda"`` unless the caller asks for the CPU.

Quick start::

    from mlqem_tpu_torch import (IsingLabelPipeline, KickedIsingEngine,
                                 configurable_device)

    eng = KickedIsingEngine(configurable_device(10, seed=0), nq=10,
                            steps=4, device="cuda")
    ideal, noisy = eng.generate(J_values, seed=0)   # numpy [B, 10] each

    pipe = IsingLabelPipeline(configurable_device(10, seed=0), nq=10,
                              steps=4, device="cuda", method="frame",
                              n_traj=32)
    ideal, noisy = pipe.generate(J_values, seed=0)

    lc = LightconeIsing(configurable_device(100, seed=1), nq=100, steps=10,
                        device="cuda", dt=0.5, h=0.66 * np.pi, n_traj=1024,
                        shots=49, t_chunk=128)
    noisy, ideal = lc.generate_stepwise(J_values, qubits=(11, 25, 39, 54,
                                                          94))

    dev = get_device("fake_lima")
    qc = Circuit(2).h(0).cx(0, 1)
    noisy = NoisyEstimator(dev, device="cuda").run(
        qc, PauliSum("ZZ")).result().values

    out = train_gnn_mitigation(dev, device="cuda")   # the paper's GNN
    NgemNoisy = ngem(NoisyEstimator, out["model"], dev, device="cuda",
                     pad_nodes=out["pad_nodes"], pad_edges=out["pad_edges"])
    mitigated = NgemNoisy(dev, device="cuda").run(qc, PauliSum("ZZ"))

    ds = random_circuit_dataset(configurable_device(10, seed=0), 10, 6,
                                num_circuits=200, device="cuda")
    table = model_comparison(ds, configurable_device(10, seed=0),
                             device="cuda")        # OLS / RF / MLP1 / GNN
    sweep = zne_sweep_ising(configurable_device(20, seed=0), nq=20,
                            device="cuda")         # K3 at 20 qubits
    demo1 = demo1_zne_mimic_100q(device="cuda", num_twirls=1024,
                                 num_twirls_amp=256, shots=49, t_chunk=128)

    pp = PauliPropagatorIsing(configurable_device(100, seed=1), nq=100,
                              steps=10, dt=0.5, h=0.5 * np.pi,
                              max_terms=131072, device="cuda")
    values, discarded = pp.generate_stepwise(J_values, noise_scale=1,
                                             qubits=(0, 49, 99))
    labels = batch_expectations(clifford_circuits, single_z(0, 400),
                                device="cuda")    # stabilizer tableau
    parity = single_ising_parity("incoherent", device="cuda")

    rows = h2_dissociation_curve(get_device("fake_lima"), device="cuda")

    mesh = make_mesh(device="cuda")       # one rank a card
    ideal, noisy = eng.generate(J_values, seed=0, mesh=mesh)
    dryrun_multichip(8, device="cpu")      # 8 gloo ranks on the host
"""

from .apps.chemistry import load_h2_problems
from .apps.vqe import VQE, VQEResult, exact_minimum_eigenvalue, spsa_minimize
from .circuits.circuit import Circuit, stack_circuits, tensorize
from .circuits.observables import PauliSum
from .data.generators import ExpValueEntry, generate_exp_val_dataset
from .data.loaders import ExpValDataset
from .device.model import DeviceModel
from .device.noise import NoiseModel, add_coherent_cx_noise
from .device.registry import configurable_device, get_device
from .entry import dryrun_multichip
from .exceptions import MLQEMException
from .metrics import Problem, Trial, improvement_factor, rmse
from .mitigation.learning import (EmptyProcessor, ModelProcessor,
                                  TorchModelProcessor, ZNEProcessor, learning)
from .mitigation.ngem import GNNProcessor, ngem
from .mitigation.twirling import sample_twirled_circuits, twirl_circuit
from .mitigation.zne import (LinearExtrapolator, PolynomialExtrapolator,
                             RichardsonExtrapolator, ZNEEstimator,
                             ZNEStrategy, zne)
from .models.forest import RandomForestRegressor
from .models.gnn import (ExpValCircuitGraphModel, ExpValCircuitGraphModel2,
                         ExpValCircuitGraphModel3, ExpValCircuitGraphModel4,
                         NgemEnsembleModel)
from .models.linear import LinearRegression
from .models.mlp import MLP1, MLP2, MLP3
from .models.train import predict, train_gnn, train_mlp, train_model
from .ops.kicked_ising import KickedIsingEngine
from .ops.lightcone import LightconeIsing
from .ops.pauli_prop import PauliPropagatorIsing
from .ops.sharded_sv import sharded_statevector_fn, sharded_z_expectations
from .ops.stabilizer import (StabilizerState, batch_expectations,
                             clifford_inverse_circuit,
                             construct_random_clifford,
                             force_nonzero_expectation)
from .parallel.datagen import IsingLabelPipeline, make_ising_template
from .parallel.mesh import make_mesh, pad_to_multiple, spawn
from .primitives.estimator import (BaseEstimator, CountsBackend,
                                   EstimatorResult, IdealEstimator, Job,
                                   NoisyEstimator)
from .primitives.trajectory_estimator import TrajectoryEstimator
from .workflows.datasets import (LabeledDataset, dataset_imbalance,
                                 ising_dataset, ising_step_sweep,
                                 mbl_dataset, noise_setting,
                                 random_circuit_dataset, tiling_dataset)
from .workflows.demos import (demo1_zne_mimic_100q, demo2_ising_4q,
                              lightcone_crosscheck, truncation_convergence)
from .workflows.generalization import generalization_study
from .workflows.gnn_training import (tomography_sweep, train_gnn_mbl,
                                     train_gnn_mitigation)
from .workflows.mitigate import (encode_dataset, graph_encode_dataset,
                                 model_comparison, train_gnn_on_dataset,
                                 train_mitigation_model, train_zne_mimic,
                                 zne_batch)
from .workflows.paper_parity import (PUBLISHED, paper_parity_study,
                                     single_ising_parity)
from .workflows.schemas import check_demo1, check_demo2, check_paper_parity
from .workflows.transfer import (calibration_drift, calibration_snapshots,
                                 device_at_time, finetune, scalability_sweep)
from .workflows.vqe_study import (PUBLISHED_H2, h2_dissociation_curve,
                                  train_vqe_processor, vqe_dataset,
                                  vqe_mitigation_study)
from .workflows.zne_scale import zne_sweep_ising

__all__ = ["BaseEstimator", "Circuit", "CountsBackend", "DeviceModel",
           "EmptyProcessor", "EstimatorResult", "ExpValCircuitGraphModel",
           "ExpValCircuitGraphModel2", "ExpValCircuitGraphModel3",
           "ExpValCircuitGraphModel4", "ExpValDataset", "ExpValueEntry",
           "GNNProcessor", "IdealEstimator", "IsingLabelPipeline", "Job",
           "KickedIsingEngine", "LabeledDataset", "LightconeIsing",
           "LinearExtrapolator", "LinearRegression", "MLP1", "MLP2", "MLP3",
           "MLQEMException", "ModelProcessor", "NgemEnsembleModel",
           "NoiseModel", "NoisyEstimator", "PUBLISHED", "PUBLISHED_H2",
           "PauliPropagatorIsing", "PauliSum", "PolynomialExtrapolator",
           "Problem", "RandomForestRegressor", "RichardsonExtrapolator",
           "StabilizerState", "TorchModelProcessor", "TrajectoryEstimator",
           "Trial", "VQE", "VQEResult", "ZNEEstimator", "ZNEProcessor",
           "ZNEStrategy", "add_coherent_cx_noise", "batch_expectations",
           "calibration_drift", "calibration_snapshots", "check_demo1",
           "check_demo2", "check_paper_parity", "clifford_inverse_circuit", "configurable_device",
           "construct_random_clifford", "dataset_imbalance",
           "demo1_zne_mimic_100q", "demo2_ising_4q", "device_at_time",
           "dryrun_multichip",
           "encode_dataset", "exact_minimum_eigenvalue", "finetune",
           "force_nonzero_expectation", "generalization_study",
           "generate_exp_val_dataset", "get_device", "graph_encode_dataset",
           "h2_dissociation_curve", "improvement_factor", "ising_dataset",
           "ising_step_sweep", "learning", "lightcone_crosscheck",
           "load_h2_problems", "make_ising_template", "make_mesh",
           "mbl_dataset",
           "model_comparison", "ngem", "noise_setting", "pad_to_multiple",
           "paper_parity_study",
           "predict", "random_circuit_dataset", "rmse",
           "sample_twirled_circuits", "scalability_sweep",
           "sharded_statevector_fn", "sharded_z_expectations",
           "single_ising_parity", "spawn", "spsa_minimize", "stack_circuits",
           "tensorize", "tiling_dataset", "tomography_sweep", "train_gnn",
           "train_gnn_mbl", "train_gnn_mitigation", "train_gnn_on_dataset",
           "train_mitigation_model", "train_mlp", "train_model",
           "train_vqe_processor", "train_zne_mimic", "truncation_convergence",
           "twirl_circuit", "vqe_dataset", "vqe_mitigation_study", "zne",
           "zne_batch", "zne_sweep_ising"]
