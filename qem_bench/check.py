"""The numbers that decide ``correct``.

``ideal_max_err``: the widest gap between the program's noise-free labels
and the reference's, over every label compared. The noisy labels are
Monte-Carlo estimates, so they are judged against the reference's own
trajectories through the estimator's variance: with d the gap between a
label and the reference's mean and v the variance of that gap (the
program's estimator, from the reference's per-trajectory moments, plus the
reference mean's own),
``noisy_chi2_dev`` = |mean(d²/v) − 1| (near 0 for an estimator of the
right mean and spread; more where labels are biased, or noisier than the
trajectories and shots the traffic asks for), and ``noisy_bias_z`` =
|Σ d·m| / sqrt(Σ m²·v), m the reference's mean (a z-score of a shrinking
or growing of the labels, such as a wrong noise strength or readout).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

VAR_FLOOR = 1e-12


def ideal_max_err(prog: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(np.asarray(prog, np.float64) - ref).max())


def noisy_numbers(prog, mean, var_prog, var_ref, bias_mask=None
                  ) -> Dict[str, float]:
    prog, mean = (np.asarray(x, np.float64).ravel() for x in (prog, mean))
    v = (np.asarray(var_prog, np.float64).ravel()
         + np.asarray(var_ref, np.float64).ravel() + VAR_FLOOR)
    d = prog - mean
    m = np.ones_like(d, bool) if bias_mask is None else np.asarray(
        bias_mask, bool).ravel()
    bias = abs(float((d * mean)[m].sum())) / float(
        np.sqrt((mean ** 2 * v)[m].sum()) + 1e-300)
    chi2 = float(np.mean(d * d / v))
    return {"noisy_chi2_dev": abs(chi2 - 1.0), "noisy_bias_z": bias,
            "_noisy_chi2": chi2, "_noisy_labels": d.size}


def moments(z: np.ndarray, axis: int):
    """(mean, sample variance, mean square) of per-trajectory values."""
    z = np.asarray(z, np.float64)
    return (z.mean(axis=axis), z.var(axis=axis, ddof=1),
            (z * z).mean(axis=axis))
