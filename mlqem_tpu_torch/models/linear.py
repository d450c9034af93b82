"""Linear regression (closed-form) — the OLS baseline of ``h12_ols``.

Counterpart of ``mlqem_tpu/models/linear.py``: drop-in for
``sklearn.linear_model.LinearRegression`` in the reference's model-zoo
sweeps. ``fit`` is one float64 normal-equations solve on the host;
``predict`` is one float32 torch product on ``device``.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


class LinearRegression:
    """Ordinary least squares with optional L2 (ridge) regularization."""

    def __init__(self, alpha: float = 0.0, fit_intercept: bool = True,
                 device: Union[str, torch.device] = "cuda"):
        self.alpha = alpha
        self.fit_intercept = fit_intercept
        self.device = torch.device(device)
        self.coef_: Optional[np.ndarray] = None
        self.intercept_: Optional[np.ndarray] = None

    def fit(self, X, y):
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        squeeze = y.ndim == 1
        if squeeze:
            y = y[:, None]
        if self.fit_intercept:
            Xd = np.concatenate([X, np.ones((X.shape[0], 1))], axis=1)
        else:
            Xd = X
        d = Xd.shape[1]
        gram = Xd.T @ Xd
        if self.alpha > 0:
            reg = self.alpha * np.eye(d)
            if self.fit_intercept:
                reg[-1, -1] = 0.0  # don't penalize the intercept
            gram = gram + reg
        w = np.linalg.lstsq(gram, Xd.T @ y, rcond=None)[0]
        if self.fit_intercept:
            self.coef_ = w[:-1].T
            self.intercept_ = w[-1]
        else:
            self.coef_ = w.T
            self.intercept_ = np.zeros(y.shape[1])
        if squeeze:
            self.coef_ = self.coef_[0]
            self.intercept_ = self.intercept_[0]
        return self

    def predict(self, X) -> np.ndarray:
        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)

        X, coef, intercept = dev(X), dev(self.coef_), dev(self.intercept_)
        out = X @ (coef if coef.ndim == 1 else coef.T) + intercept
        return out.cpu().numpy()
