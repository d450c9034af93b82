"""VQE on top of (mitigated) Estimator primitives.

Counterpart of ``mlqem_tpu/apps/vqe.py``: host numpy and scipy around any
Estimator of the port, which runs on its own device. It rebuilds the
reference's forked qiskit VQE with ``separate_observables``
(``docs/tutorials/vqe_to_substitute_with_separate_observables.py:162-286``):
when enabled, the energy is evaluated per Pauli term —
``estimator.run(batch×[ansatz], batch×[term], θ)`` then Σ coeff·values — so
a learning estimator sees single Paulis exactly as its training features
were encoded. Optimizers: scipy COBYLA (the paper's choice,
``vqe_rf.py:243-245``) and a native SPSA.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Callable, List, Optional

import numpy as np

from ..circuits.circuit import Circuit
from ..circuits.observables import PauliSum, PauliTerm
from ..circuits.parameters import circuit_parameters


@dataclasses.dataclass
class VQEResult:
    eigenvalue: float
    optimal_point: np.ndarray
    optimal_parameters: dict
    cost_function_evals: int
    optimizer_result: Optional[object] = None
    energy_history: Optional[List[float]] = None


def exact_minimum_eigenvalue(operator: PauliSum) -> float:
    """Dense exact diagonalization (the reference's comparison arm,
    ``vqe_rf.py:249-268``)."""
    return float(np.linalg.eigvalsh(operator.to_matrix())[0])


def spsa_minimize(fun: Callable[[np.ndarray], float], x0: np.ndarray,
                  maxiter: int = 100, a: float = 0.2, c: float = 0.15,
                  alpha: float = 0.602, gamma: float = 0.101,
                  seed: int = 0):
    """Simultaneous-perturbation stochastic approximation (numpy only):
    an object with ``.x``, ``.fun`` and ``.nfev``."""
    rng = np.random.default_rng(seed)
    x = np.array(x0, dtype=np.float64)
    nfev = 0
    best_x, best_f = x.copy(), np.inf
    for k in range(maxiter):
        ak = a / (k + 1 + 10) ** alpha
        ck = c / (k + 1) ** gamma
        delta = rng.choice([-1.0, 1.0], size=x.shape)
        fp = fun(x + ck * delta)
        fm = fun(x - ck * delta)
        nfev += 2
        ghat = (fp - fm) / (2 * ck) * delta
        x = x - ak * ghat
        f_now = min(fp, fm)
        if f_now < best_f:
            best_f, best_x = f_now, x.copy()
    f_final = fun(best_x)
    nfev += 1
    return types.SimpleNamespace(x=best_x, fun=min(f_final, best_f),
                                 nfev=nfev)


class VQE:
    """Variational quantum eigensolver.

    Args:
        estimator: any Estimator-primitive object of the port (ideal /
            noisy / learning / zne — they compose); it runs on its own
            device.
        ansatz: parameterized Circuit (e.g. ``two_local_ansatz``).
        optimizer: 'cobyla' (scipy) | 'spsa' (native) | a callable
            ``(fun, x0) → result`` with .x/.fun/.nfev.
        separate_observables: evaluate energy per Pauli term (T8 semantics).
    """

    def __init__(self, estimator, ansatz: Circuit,
                 optimizer: str = "cobyla",
                 maxiter: int = 100,
                 initial_point: Optional[np.ndarray] = None,
                 separate_observables: bool = False,
                 seed: int = 0,
                 callback: Optional[Callable] = None):
        self.estimator = estimator
        self.ansatz = ansatz
        self.optimizer = optimizer
        self.maxiter = maxiter
        self.initial_point = initial_point
        self.separate_observables = separate_observables
        self.seed = seed
        self.callback = callback
        self._params = circuit_parameters(ansatz)
        if not self._params:
            raise ValueError("ansatz has no parameters")

    def _energy(self, operator: PauliSum, theta: np.ndarray) -> float:
        if self.separate_observables:
            # one run() over a single-Pauli observable per term: the
            # learning estimator's contract
            circuits = [self.ansatz] * len(operator.terms)
            observables = [PauliSum([PauliTerm(t.pauli, 1.0)])
                           for t in operator.terms]
            pvals = [tuple(theta)] * len(operator.terms)
            values = self.estimator.run(
                circuits, observables, parameter_values=pvals
            ).result().values
            coeffs = np.array([np.real(t.coeff) for t in operator.terms])
            return float(np.dot(coeffs, values))
        values = self.estimator.run(
            [self.ansatz], [operator], parameter_values=[tuple(theta)]
        ).result().values
        return float(values[0])

    def compute_minimum_eigenvalue(self, operator: PauliSum) -> VQEResult:
        rng = np.random.default_rng(self.seed)
        x0 = (np.asarray(self.initial_point, dtype=np.float64)
              if self.initial_point is not None
              else rng.uniform(-np.pi, np.pi, len(self._params)))
        history: List[float] = []

        def fun(theta):
            e = self._energy(operator, np.asarray(theta))
            history.append(e)
            if self.callback is not None:
                self.callback(len(history), np.asarray(theta), e)
            return e

        if callable(self.optimizer):
            res = self.optimizer(fun, x0)
        elif self.optimizer == "cobyla":
            from scipy.optimize import minimize

            res = minimize(fun, x0, method="COBYLA",
                           options={"maxiter": self.maxiter})
        elif self.optimizer == "spsa":
            res = spsa_minimize(fun, x0, maxiter=self.maxiter,
                                seed=self.seed)
        else:
            raise ValueError(f"unknown optimizer {self.optimizer!r}")

        return VQEResult(
            eigenvalue=float(res.fun),
            optimal_point=np.asarray(res.x),
            optimal_parameters={p.name: float(v)
                                for p, v in zip(self._params, res.x)},
            cost_function_evals=int(getattr(res, "nfev", len(history))),
            optimizer_result=res,
            energy_history=history,
        )
