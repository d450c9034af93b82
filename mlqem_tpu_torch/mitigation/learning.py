"""Learning-based mitigation estimator — the framework's public centerpiece.

Counterpart of ``mlqem_tpu/mitigation/learning.py``; API parity with
``blackwater/library/learning/estimator.py``: a trained model
post-processes noisy expectation values *behind the Estimator primitive
interface*, so mitigation composes transparently with any algorithm (VQE
etc.):

* :class:`LearningMethodEstimatorProcessor` abstract ``process``
  (ref :22-30)
* :class:`ModelProcessor` — per-Pauli encode → ``model.predict`` →
  Σ coeff·pred (``ScikitLearningModelProcessor``, ref :90-148); works with
  any object exposing ``predict`` (native forest, linear, sklearn, …)
* :class:`TorchModelProcessor` — a torch module on flat features
  (``TorchLearningModelProcessor``, ref :151-187; the JAX package's
  ``FlaxModelProcessor``)
* :class:`ZNEProcessor` — delegates to a real ZNE estimator incl. observable
  padding to physical qubits (ref :33-86)
* :class:`EmptyProcessor` passthrough (ref :190-194)
* :class:`PostProcessedJob` — wraps the base job, mitigates per
  (value, circuit, observable, params), records ``original_value`` metadata
  (ref :197-259)
* :func:`learning` — dynamic subclassing decorator patching ``_run``
  (ref :262-328)
"""
from __future__ import annotations

from functools import wraps
from typing import Any, Callable, Dict, Optional, Type, Union

import numpy as np
import torch
from torch import nn

from ..circuits.circuit import Circuit
from ..circuits.observables import PauliSum, PauliTerm
from ..circuits.parameters import bind_parameters, circuit_parameters
from ..data.encoders import encode_data, encode_pauli_sum_op
from ..device.model import DeviceModel
from ..exceptions import MLQEMException
from ..primitives.estimator import BaseEstimator, EstimatorResult, Job
from ..transpile.lower import transpile


class LearningMethodEstimatorProcessor:
    """Abstract mitigation processor."""

    def process(self, expectation_value, circuits, observables,
                parameter_values):
        raise NotImplementedError


class ModelProcessor(LearningMethodEstimatorProcessor):
    """Mitigate with any ``.predict``-style regressor on flat features.

    Per Pauli term of the observable: build the reference's 58-dim-style
    feature vector (device stats + gate counts + angle bins + the noisy
    expval + encoded measurement basis) and sum coeff-weighted predictions.
    """

    def __init__(self, model: Any, backend: DeviceModel,
                 skip_transpile: bool = False):
        self._model = model
        self._backend = backend
        self._properties = backend.properties()
        self._skip_transpile = skip_transpile

    def _predict(self, X: np.ndarray) -> float:
        return float(np.asarray(self._model.predict(X)).reshape(-1)[0])

    def process(self, expectation_value, circuits, observables,
                parameter_values):
        circuit: Circuit = circuits
        if not self._skip_transpile:
            circuit = transpile(circuit, basis=self._backend.basis_gates)
        results = []
        for term in observables.terms:
            X, _ = encode_data(
                circuits=[circuit],
                properties=self._properties,
                ideal_exp_vals=[[0.0]],
                noisy_exp_vals=[[float(expectation_value)]],
                num_qubits=1,
                meas_bases=encode_pauli_sum_op(PauliSum([
                    PauliTerm(term.pauli, 1.0)])),
            )
            results.append(self._predict(X) * float(np.real(term.coeff)))
        return float(np.sum(results))


class TorchModelProcessor(ModelProcessor):
    """Mitigate with a torch module on flat features (the reference's
    ``TorchLearningModelProcessor``): ``state_dict`` (when given) is loaded,
    the module moves to ``device`` and runs in eval mode."""

    def __init__(self, model: nn.Module,
                 state_dict: Optional[Dict[str, torch.Tensor]],
                 backend: DeviceModel, skip_transpile: bool = False,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(model, backend, skip_transpile)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self._device = torch.device(device)
        model.to(self._device).eval()

    def _predict(self, X: np.ndarray) -> float:
        with torch.no_grad():
            out = self._model(torch.as_tensor(X, device=self._device))
        return float(out.reshape(-1)[0])


class ZNEProcessor(LearningMethodEstimatorProcessor):
    """Mitigate by actually running digital ZNE (ref :33-86).

    Pads the observable to the backend's physical width when the circuit is
    wider than the logical observable (the reference's
    ``form_all_qubit_observable`` behavior).
    """

    def __init__(self, zne_estimator, backend: DeviceModel,
                 shots: Optional[int] = 10000,
                 zne_strategy=None):
        self._zne_estimator = zne_estimator
        self._backend = backend
        self._shots = shots
        self._zne_strategy = zne_strategy

    def process(self, expectation_value, circuits, observables,
                parameter_values):
        circuit: Circuit = circuits
        obs = observables
        if obs.num_qubits < circuit.num_qubits:
            padded = []
            for term in obs.terms:
                s = "I" * (circuit.num_qubits - obs.num_qubits) + term.pauli
                padded.append((s, term.coeff))
            obs = PauliSum(padded)
        kwargs = {}
        if self._zne_strategy is not None:
            kwargs["zne_strategy"] = self._zne_strategy
        if self._shots is not None:
            kwargs["shots"] = self._shots
        job = self._zne_estimator.run([circuit], [obs], **kwargs)
        return float(job.result().values[0])


class EmptyProcessor(LearningMethodEstimatorProcessor):
    def process(self, expectation_value, circuits, observables,
                parameter_values):
        return expectation_value


class PostProcessedJob(Job):
    """Wraps a base job; mitigation happens lazily in ``result()``."""

    def __init__(self, base_job: Job,
                 processor: LearningMethodEstimatorProcessor,
                 circuits, observables, parameter_values,
                 skip_transpile: bool,
                 backend: Optional[DeviceModel] = None,
                 job_id: Optional[str] = None):
        self._base_job = base_job
        self._processor = processor
        self._circuits = circuits
        self._observables = observables
        self._parameter_values = parameter_values
        self._skip_transpile = skip_transpile
        self._backend = backend
        self._job_id = job_id or base_job.job_id()

    def result(self) -> EstimatorResult:
        result = self._base_job.result()
        mitigated = []
        metadata = []
        for value, circuit, obs, params, meta in zip(
                result.values, self._circuits, self._observables,
                self._parameter_values, result.metadata):
            if isinstance(obs, str):
                obs = PauliSum(obs)
            if not isinstance(obs, PauliSum):
                raise MLQEMException(
                    "Only PauliSum observables are supported by the "
                    "learning primitive.")
            bound = circuit
            if circuit_parameters(circuit):
                bound = bind_parameters(circuit, list(params))
            # Lowering to the device basis happens in exactly one place: the
            # processor (its own skip_transpile flag), as in the JAX package.
            mitigated.append(self._processor.process(
                expectation_value=value, circuits=bound, observables=obs,
                parameter_values=params))
            metadata.append({**meta, "original_value": float(value)})
        return EstimatorResult(np.asarray(mitigated), metadata)

    def submit(self):
        return self._base_job.submit() if hasattr(self._base_job, "submit") \
            else None

    def status(self):
        return self._base_job.status()

    def cancel(self):
        return self._base_job.cancel()

    def __repr__(self):
        return f"<PostProcessedJob: {self._job_id}>"


def patch_run(run: Callable, processor: LearningMethodEstimatorProcessor,
              skip_transpile: bool,
              backend: Optional[DeviceModel] = None) -> Callable:
    """Wrap an Estimator ``_run`` with post-processing (ref :262-298)."""

    @wraps(run)
    def patched_run(self, circuits, observables, parameter_values=None,
                    **run_options) -> Job:
        job = run(self, circuits, observables,
                  parameter_values=parameter_values, **run_options)
        circs = [circuits] if isinstance(circuits, Circuit) else list(circuits)
        obs = observables
        if isinstance(obs, (PauliSum, str)):
            obs = [obs] * len(circs)
        pvals = parameter_values
        if pvals is None:
            pvals = [()] * len(circs)
        return PostProcessedJob(
            job, processor=processor, circuits=circs, observables=obs,
            parameter_values=pvals, skip_transpile=skip_transpile,
            backend=backend, job_id=job.job_id())

    return patched_run


def learning(cls: Type[BaseEstimator],
             processor: LearningMethodEstimatorProcessor,
             skip_transpile: bool = False,
             backend: Optional[DeviceModel] = None):
    """Turn an Estimator class into a LearningEstimator class (ref :301-328).

    Returns a dynamic subclass named ``Learning<cls>`` whose ``_run`` wraps
    the original and post-processes each expectation value through the
    processor.
    """
    new_class: type = type(f"Learning{cls.__name__}", (cls,), {})
    new_class._run = patch_run(new_class._run, processor, skip_transpile,
                               backend)
    return new_class
