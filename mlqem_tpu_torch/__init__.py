"""mlqem_tpu_torch — ML-QEM training-label generators in PyTorch and CUDA.

A port of the JAX package ``mlqem_tpu`` to PyTorch, with its TPU kernels
as hand-written CUDA kernels for Hopper: the kicked-Ising evolution
(``csrc/evolve.cu``), the generic Pauli-frame evolution
(``csrc/frame_evolve.cu``), one Trotter step (``csrc/fused_step.cu``) and
the Walsh–Hadamard transform over device-memory planes (``csrc/wht.cu``),
the last two on the light-cone engine's path; the exact density-matrix
engines, the Estimator primitives, digital ZNE and the learning stack
(datasets, the paper's GNN, the MLP/linear/forest regressors, the trainer
and the ``learning``/``ngem`` Estimators) are plain PyTorch. It mirrors
the JAX package's module paths and imports neither JAX nor ``mlqem_tpu``.

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
"""

from .circuits.circuit import Circuit, stack_circuits, tensorize
from .circuits.observables import PauliSum
from .data.generators import ExpValueEntry, generate_exp_val_dataset
from .data.loaders import ExpValDataset
from .device.model import DeviceModel
from .device.noise import NoiseModel
from .device.registry import configurable_device, get_device
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
from .parallel.datagen import IsingLabelPipeline, make_ising_template
from .primitives.estimator import (BaseEstimator, CountsBackend,
                                   EstimatorResult, IdealEstimator, Job,
                                   NoisyEstimator)
from .primitives.trajectory_estimator import TrajectoryEstimator
from .workflows.gnn_training import tomography_sweep, train_gnn_mitigation

__all__ = ["BaseEstimator", "Circuit", "CountsBackend", "DeviceModel",
           "EmptyProcessor", "EstimatorResult", "ExpValCircuitGraphModel",
           "ExpValCircuitGraphModel2", "ExpValCircuitGraphModel3",
           "ExpValCircuitGraphModel4", "ExpValDataset", "ExpValueEntry",
           "GNNProcessor", "IdealEstimator", "IsingLabelPipeline", "Job",
           "KickedIsingEngine", "LightconeIsing", "LinearExtrapolator",
           "LinearRegression", "MLP1", "MLP2", "MLP3", "MLQEMException",
           "ModelProcessor", "NgemEnsembleModel", "NoiseModel",
           "NoisyEstimator", "PauliSum", "PolynomialExtrapolator", "Problem",
           "RandomForestRegressor", "RichardsonExtrapolator",
           "TorchModelProcessor", "TrajectoryEstimator", "Trial",
           "ZNEEstimator", "ZNEProcessor", "ZNEStrategy",
           "configurable_device", "generate_exp_val_dataset", "get_device",
           "improvement_factor", "learning", "make_ising_template", "ngem",
           "predict", "rmse", "sample_twirled_circuits", "stack_circuits",
           "tensorize", "tomography_sweep", "train_gnn",
           "train_gnn_mitigation", "train_mlp", "train_model",
           "twirl_circuit", "zne"]
