"""Carry state from the JAX package into the port.

Every function takes plain Python and numpy values, so the port never
imports the JAX package: a caller that has both (a test) hands over what
the JAX side produced.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .circuits.circuit import CircuitTensor
from .circuits.parameters import CircuitTemplate, Parameter
from .device.model import DeviceModel
from .models.forest import RandomForestRegressor
from .models.linear import LinearRegression
from .ops.kicked_ising import EngineTables
from .parallel.datagen import PipelineTables


def device_from_jax_dict(d: dict) -> DeviceModel:
    """A port :class:`DeviceModel` from ``mlqem_tpu``'s
    ``DeviceModel.to_dict()`` output."""
    return DeviceModel.from_dict(d)


def engine_tables_from_numpy(bond_probs: np.ndarray,
                             confusion: Optional[np.ndarray],
                             device: Union[str, torch.device]
                             ) -> EngineTables:
    """Engine tables from the JAX engine's ``_bond_probs`` [n_bonds, 16]
    and ``_confusion`` [nq, 2, 2] (or None).

    Assign the result to a port engine's ``tables`` to make it sample and
    read out exactly as that JAX engine does.
    """
    bond_probs = np.asarray(bond_probs, np.float32)
    if bond_probs.ndim != 2 or bond_probs.shape[1] != 16:
        raise ValueError(f"bond_probs must be [n_bonds, 16], got "
                         f"{bond_probs.shape}")
    return EngineTables(torch.as_tensor(bond_probs, device=device),
                        _confusion_tensor(confusion, device))


def _confusion_tensor(confusion: Optional[np.ndarray],
                      device) -> Optional[torch.Tensor]:
    if confusion is None:
        return None
    confusion = np.asarray(confusion, np.float32)
    if confusion.ndim != 3 or confusion.shape[1:] != (2, 2):
        raise ValueError(f"confusion must be [nq, 2, 2], got "
                         f"{confusion.shape}")
    return torch.as_tensor(confusion, device=device)


def circuit_tensor_from_numpy(gate_ids: np.ndarray, qubits: np.ndarray,
                              params: np.ndarray, num_qubits: int
                              ) -> CircuitTensor:
    """A port :class:`CircuitTensor` from a JAX one's arrays."""
    return CircuitTensor(np.asarray(gate_ids, np.int32),
                         np.asarray(qubits, np.int32),
                         np.asarray(params, np.float32), int(num_qubits))


def template_from_numpy(gate_ids: np.ndarray, qubits: np.ndarray,
                        params: np.ndarray, num_qubits: int,
                        slot_op: np.ndarray, slot_par: np.ndarray,
                        slot_param: np.ndarray, slot_coeff: np.ndarray,
                        parameter_names: Sequence[str]) -> CircuitTemplate:
    """A port :class:`CircuitTemplate` from a JAX template's ``ct`` arrays,
    ``slot_*`` arrays and parameter names (in order)."""
    return CircuitTemplate(
        circuit_tensor_from_numpy(gate_ids, qubits, params, num_qubits),
        np.asarray(slot_op, np.int32), np.asarray(slot_par, np.int32),
        np.asarray(slot_param, np.int32), np.asarray(slot_coeff, np.float32),
        [Parameter(name) for name in parameter_names])


def pipeline_tables_from_numpy(pauli_probs: np.ndarray,
                               confusion: Optional[np.ndarray],
                               device: Union[str, torch.device]
                               ) -> PipelineTables:
    """Pipeline tables from a JAX pipeline's ``_pauli_probs`` [L, 16] and
    ``_confusion`` [nq, 2, 2] (or None).

    Assign the result to a port pipeline's ``tables`` to make it sample and
    read out exactly as that JAX pipeline does.
    """
    pauli_probs = np.asarray(pauli_probs, np.float32)
    if pauli_probs.ndim != 2 or pauli_probs.shape[1] != 16:
        raise ValueError(f"pauli_probs must be [L, 16], got "
                         f"{pauli_probs.shape}")
    return PipelineTables(torch.as_tensor(pauli_probs, device=device),
                          _confusion_tensor(confusion, device))


def noise_table_from_numpy(key_ids: np.ndarray, table: np.ndarray,
                           device: Union[str, torch.device]
                           ) -> Tuple[np.ndarray, torch.Tensor]:
    """(key_ids int32 on the host, table complex64 [K, 16, 16] on
    ``device``) from the JAX ``compile_noise_table`` output, for the
    density-matrix engines (``run_density_static``, ``run_density``) or a
    pipeline's ``_keys``/``_table``."""
    key_ids = np.asarray(key_ids, np.int32)
    table = np.array(table, np.complex64)
    if table.ndim != 3 or table.shape[1:] != (16, 16):
        raise ValueError(f"table must be [K, 16, 16], got {table.shape}")
    if key_ids.size and not 0 <= key_ids.min() <= key_ids.max() < len(table):
        raise ValueError(f"key_ids must index the table's {len(table)} "
                         f"entries, got [{key_ids.min()}, {key_ids.max()}]")
    return key_ids, torch.as_tensor(table, device=device)


def density_from_numpy(dm: np.ndarray, device: Union[str, torch.device]
                       ) -> torch.Tensor:
    """A complex64 density-matrix batch [..., 2^n, 2^n] on ``device`` from
    a JAX one (``batch_density_matrices_from``'s ``dm0``)."""
    dm = np.array(dm, np.complex64)
    dim = dm.shape[-1] if dm.ndim >= 2 else 0
    if dm.ndim < 2 or dm.shape[-2] != dim or dim < 4 or dim & (dim - 1):
        raise ValueError(f"dm must be [..., 2^n, 2^n] with n >= 2, got "
                         f"{dm.shape}")
    return torch.as_tensor(dm, device=device)


def state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of a port model from the flax ``variables`` tree
    (``{"params": …, "batch_stats": …}``, numpy leaves) of the same JAX
    model: ``MLP1``-``MLP3``, ``ExpValCircuitGraphModel`` 1-4 and
    ``NgemEnsembleModel``.

    The port names its submodules as flax does (``backbone/pooling1/
    fitness/w1``, ``MLP3_0/BatchNorm_0``, ``cheb1/Dense_2``, …), so each
    leaf maps by its path: a ``Dense`` ``kernel`` [in, out] becomes
    ``weight`` [out, in]; ``bias``, and ``BatchNorm``'s ``scale`` and
    ``mean``/``var`` statistics, keep their names.
    """
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, path):
        for key, val in tree.items():
            if isinstance(val, Mapping):
                walk(val, path + [key])
                continue
            arr = np.array(val, np.float32)
            if key == "kernel":
                key, arr = "weight", np.ascontiguousarray(arr.T)
            out[".".join(path + [key])] = torch.as_tensor(arr)

    for collection in ("params", "batch_stats"):
        walk(variables.get(collection, {}), [])
    return out


def forest_from_jax(stacked: Sequence[np.ndarray], depth: int,
                    single_output: bool,
                    device: Union[str, torch.device] = "cuda"
                    ) -> RandomForestRegressor:
    """A fitted port forest from a fitted JAX ``RandomForestRegressor``:
    its ``_stacked`` arrays (feature, threshold, left, right, value), its
    ``_depth`` and its ``_single_output``."""
    rf = RandomForestRegressor(n_estimators=len(np.asarray(stacked[0])),
                               device=device)
    rf._single_output = bool(single_output)
    return rf.set_stacked(*[np.asarray(a) for a in stacked], depth)


def linear_from_jax(coef: np.ndarray, intercept,
                    device: Union[str, torch.device] = "cuda"
                    ) -> LinearRegression:
    """A fitted port ``LinearRegression`` from a JAX one's ``coef_`` and
    ``intercept_``."""
    lr = LinearRegression(device=device)
    lr.coef_ = np.asarray(coef)
    lr.intercept_ = np.asarray(intercept)
    return lr
