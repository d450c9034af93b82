"""Metrics: improvement factor and the notebook-side evaluation stats.

Counterpart of ``mlqem_tpu/metrics/__init__.py`` (host numpy).
``improvement_factor`` follows arXiv:2210.07194 with exact parity to
``blackwater/metrics/improvement_factor.py:47-114``; the rest are the
evaluation metrics the reference computes in notebooks (RMSE per qubit,
L2-vs-step, MBL charge imbalance).
"""
from __future__ import annotations

import dataclasses
from math import sqrt
from typing import List, Optional

import numpy as np

from ..data.encoders import calc_imbalance  # re-export
from ..exceptions import MLQEMException


@dataclasses.dataclass
class Trial:
    """One mitigation trial: noisy + mitigated expval pair."""

    noisy: float
    mitigated: float


@dataclasses.dataclass
class Problem:
    """A circuit/observable problem with its trials and true expval."""

    trials: List[Trial]
    ideal_exp_value: float
    circuit: Optional[object] = None
    observable: Optional[object] = None


def improvement_factor(problems, n_shots: int, n_mitigation_shots: int):
    """√(n_shots·Σ(noisy−ideal)²) / √(n_mit_shots·Σ(mitigated−ideal)²).

    Accepts Problem dataclasses or nested (ideal, [(noisy, mitigated)...])
    tuples, matching the reference's dual input form.
    """
    if len(problems) == 0:
        raise MLQEMException("Problem list should not be empty.")
    if not isinstance(problems[0], Problem):
        problems = [
            Problem(trials=[Trial(noisy=n, mitigated=m) for n, m in trials],
                    ideal_exp_value=ideal)
            for ideal, trials in problems
        ]
    numerator = sqrt(n_shots * sum(
        sum((t.noisy - p.ideal_exp_value) ** 2 for t in p.trials)
        for p in problems))
    denominator = sqrt(n_mitigation_shots * sum(
        sum((t.mitigated - p.ideal_exp_value) ** 2 for t in p.trials)
        for p in problems))
    return numerator / denominator


def rmse(pred, target, axis=None) -> np.ndarray:
    """Root-mean-square error (the demo notebooks' headline metric)."""
    pred = np.asarray(pred, np.float64)
    target = np.asarray(target, np.float64)
    return np.sqrt(np.mean((pred - target) ** 2, axis=axis))


def mae(pred, target, axis=None) -> np.ndarray:
    pred = np.asarray(pred, np.float64)
    target = np.asarray(target, np.float64)
    return np.mean(np.abs(pred - target), axis=axis)


def l2_distance_per_step(pred, target) -> np.ndarray:
    """L2 distance vs ideal per Trotter step (demo2's evaluation):
    inputs [steps, n_obs] → [steps]."""
    pred = np.asarray(pred, np.float64)
    target = np.asarray(target, np.float64)
    return np.sqrt(np.sum((pred - target) ** 2, axis=-1))


__all__ = [
    "Trial", "Problem", "improvement_factor", "rmse", "mae",
    "l2_distance_per_step", "calc_imbalance",
]
