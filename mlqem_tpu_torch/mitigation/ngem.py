"""NGEM: graph-neural mitigation behind the Estimator primitive.

Counterpart of ``mlqem_tpu/mitigation/ngem.py``; parity with
``blackwater/library/ngem/estimator.py``: for each noisy expectation value,
the bound circuit is graph-encoded (qubit + gate calibration features on),
packed into the :class:`ExpValueEntry` array form, and the GNN maps (noisy
value, observable, depth, graph) → mitigated value (``NgemJob``, ref
:23-98; ``ngem()`` decorator, ref :137-158). As in the reference, the graph
gets no self-loops here, where ``ExpValDataset`` adds them for training.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Type, Union

import numpy as np
import torch
from torch import nn

from ..circuits.circuit import Circuit
from ..data.encoders import encode_pauli_sum_op
from ..data.generators import ExpValueEntry
from ..data.graph import circuit_to_graph_data_json
from ..device.model import DeviceModel
from ..models.train import gnn_inputs
from ..primitives.estimator import BaseEstimator
from ..transpile.lower import transpile
from .learning import patch_run


class GNNProcessor:
    """Wrap a torch GNN (+ ``state_dict``) as a mitigation processor.

    ``pad_nodes``/``pad_edges`` fix the padded graph shape (set them to the
    training-time padding). The module moves to ``device`` and runs in
    eval mode.
    """

    def __init__(self, model: nn.Module,
                 state_dict: Optional[Dict[str, torch.Tensor]],
                 backend: DeviceModel, pad_nodes: int = 64,
                 pad_edges: int = 160, skip_transpile: bool = False,
                 device: Union[str, torch.device] = "cuda"):
        self._model = model
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self._device = torch.device(device)
        model.to(self._device).eval()
        self._backend = backend
        self._properties = backend.properties()
        self._pad_nodes = pad_nodes
        self._pad_edges = pad_edges
        self._skip_transpile = skip_transpile

    def process(self, expectation_value, circuits, observables,
                parameter_values):
        circuit: Circuit = circuits
        if not self._skip_transpile:
            circuit = transpile(circuit, basis=self._backend.basis_gates)
        graph = circuit_to_graph_data_json(
            circuit, self._properties, use_gate_features=True,
            use_qubit_features=True)
        entry = ExpValueEntry(
            circuit_graph=graph,
            observable=encode_pauli_sum_op(observables),
            ideal_exp_value=0.0,
            noisy_exp_values=[float(expectation_value)],
            circuit_depth=circuit.depth(),
        )
        arrays = entry.to_arrays(self._pad_nodes, self._pad_edges)
        batch = {k: torch.as_tensor(np.asarray(v)[None], device=self._device)
                 for k, v in arrays.items()}
        with torch.no_grad():
            out = self._model(*gnn_inputs(batch))
        return float(out.reshape(-1)[0])


def ngem(cls: Type[BaseEstimator], model: Any, backend: DeviceModel,
         state_dict: Optional[Dict[str, torch.Tensor]] = None,
         skip_transpile: bool = False, pad_nodes: int = 64,
         pad_edges: int = 160, device: Union[str, torch.device] = "cuda"):
    """Decorator parity with ``ngem(EstimatorCls, model, backend, options)``
    (ref :137-158): returns ``Ngem<cls>`` whose results are GNN-mitigated.

    ``model`` may be a ready processor (has ``process``) or a torch GNN with
    its trained ``state_dict``, run on ``device``.
    """
    if hasattr(model, "process"):
        processor = model
    else:
        processor = GNNProcessor(model, state_dict, backend,
                                 pad_nodes=pad_nodes, pad_edges=pad_edges,
                                 skip_transpile=skip_transpile, device=device)
    new_class: type = type(f"Ngem{cls.__name__}", (cls,), {})
    new_class._run = patch_run(new_class._run, processor,
                               skip_transpile=True, backend=backend)
    return new_class
