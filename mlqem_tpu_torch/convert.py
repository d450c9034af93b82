"""Carry state from the JAX package into the port.

Both take plain Python and numpy values, so the port never imports the JAX
package: a caller that has both (a test) hands over what the JAX side
produced.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from .device.model import DeviceModel
from .ops.kicked_ising import EngineTables


def device_from_jax_dict(d: dict) -> DeviceModel:
    """A port :class:`DeviceModel` from ``mlqem_tpu``'s
    ``DeviceModel.to_dict()`` output."""
    return DeviceModel.from_dict(d)


def engine_tables_from_numpy(bond_probs: np.ndarray,
                             confusion: Optional[np.ndarray],
                             device: Union[str, torch.device] = "cpu"
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
    if confusion is not None:
        confusion = np.asarray(confusion, np.float32)
        if confusion.ndim != 3 or confusion.shape[1:] != (2, 2):
            raise ValueError(f"confusion must be [nq, 2, 2], got "
                             f"{confusion.shape}")
        confusion = torch.as_tensor(confusion, device=device)
    return EngineTables(torch.as_tensor(bond_probs, device=device),
                        confusion)
