"""Digital zero-noise extrapolation (ZNE).

Replaces the external ``zne`` prototype package the reference depends on
(``docs/tutorials/zne_parallel.py:10-12,168-208``): noise amplification by
digital gate folding (``LocalFoldingAmplifier(gates_to_fold=2)`` semantics —
fold two-qubit gates G → G·G†·G) and Linear/Polynomial/Richardson/
Exponential extrapolators, behind a ``zne(Estimator)``-style wrapper with a
``ZNEStrategy``. Counterpart of ``mlqem_tpu/mitigation/zne.py``: the
noise-factor sweep is one wider circuit batch for the base estimator.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from ..circuits.circuit import Circuit
from ..circuits.gates import GATE_NUM_QUBITS, is_structural
from ..primitives.estimator import (BaseEstimator, EstimatorResult, Job,
                                    _normalize_run_args)
from ..transpile.lower import invert_op


# ---------------------------------------------------------------------------
# Folding (noise amplification)
# ---------------------------------------------------------------------------
def fold_gates(circuit: Circuit, noise_factor: float,
               gates_to_fold: Optional[int] = 2,
               seed: int = 0) -> Circuit:
    """Local unitary folding: selected gates G → G (G† G)^k.

    noise_factor 1 → unchanged; 3 → every eligible gate folded once; even /
    fractional factors fold a deterministic subset (scaled gate count
    ≈ noise_factor × original).

    Args:
        gates_to_fold: 2 → fold only 2q gates (the reference's setting),
            1 → only 1q, None → all non-structural gates.
    """
    if noise_factor < 1:
        raise ValueError("noise_factor must be >= 1")
    eligible = []
    for i, op in enumerate(circuit.ops):
        if is_structural(op.name):
            continue
        nq = GATE_NUM_QUBITS.get(op.name, 1)
        if gates_to_fold is None or nq == gates_to_fold:
            eligible.append(i)
    n_elig = len(eligible)
    # each fold adds 2 gate applications → gate-count scale 1 + 2k/n
    total_folds = int(round((noise_factor - 1) / 2 * n_elig))
    base_folds, extra = divmod(total_folds, max(n_elig, 1))
    rng = np.random.default_rng(seed)
    extra_set = set(rng.choice(n_elig, size=extra, replace=False).tolist()) \
        if extra else set()

    out = Circuit(circuit.num_qubits, dict(circuit.metadata))
    e_idx = 0
    for i, op in enumerate(circuit.ops):
        out.ops.append(op)
        if eligible and e_idx < n_elig and eligible[e_idx] == i:
            k = base_folds + (1 if e_idx in extra_set else 0)
            for _ in range(k):
                out.ops.append(invert_op(op))
                out.ops.append(op)
            e_idx += 1
    return out


def fold_global(circuit: Circuit, noise_factor: float) -> Circuit:
    """Global folding: C → C (C† C)^k for odd integer factors."""
    k = int(round((noise_factor - 1) / 2))
    out = circuit.copy()
    body = Circuit(circuit.num_qubits)
    body.ops = [op for op in circuit.ops if not is_structural(op.name)]
    for _ in range(k):
        out = out.compose(body.inverse()).compose(body)
    return out


# ---------------------------------------------------------------------------
# Extrapolators
# ---------------------------------------------------------------------------
class Extrapolator:
    def extrapolate(self, noise_factors: Sequence[float],
                    values: Sequence[float]) -> float:
        raise NotImplementedError


@dataclasses.dataclass
class LinearExtrapolator(Extrapolator):
    """Degree-1 least squares → value at zero noise."""

    def extrapolate(self, noise_factors, values):
        coeffs = np.polyfit(noise_factors, values, 1)
        return float(np.polyval(coeffs, 0.0))


@dataclasses.dataclass
class PolynomialExtrapolator(Extrapolator):
    degree: int = 2

    def extrapolate(self, noise_factors, values):
        deg = min(self.degree, len(noise_factors) - 1)
        coeffs = np.polyfit(noise_factors, values, deg)
        return float(np.polyval(coeffs, 0.0))


@dataclasses.dataclass
class RichardsonExtrapolator(Extrapolator):
    """Exact interpolation through all points, evaluated at zero."""

    def extrapolate(self, noise_factors, values):
        x = np.asarray(noise_factors, dtype=np.float64)
        y = np.asarray(values, dtype=np.float64)
        total = 0.0
        for i in range(len(x)):
            li = 1.0
            for j in range(len(x)):
                if i != j:
                    li *= (0.0 - x[j]) / (x[i] - x[j])
            total += y[i] * li
        return float(total)


@dataclasses.dataclass
class ExponentialExtrapolator(Extrapolator):
    """Fit y = a·exp(b·x): linear fit in log |y| (sign from data)."""

    def extrapolate(self, noise_factors, values):
        y = np.asarray(values, dtype=np.float64)
        sign = 1.0 if y.mean() >= 0 else -1.0
        mag = np.clip(np.abs(y), 1e-12, None)
        b, log_a = np.polyfit(noise_factors, np.log(mag), 1)
        return float(sign * math.exp(log_a))


# ---------------------------------------------------------------------------
# Strategy + estimator wrapper
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ZNEStrategy:
    """Parity with the reference's canonical config
    (``zne_parallel.py:176-188``): noise_factors=(1, 3), local folding of
    2q gates, polynomial(deg≤2)/linear extrapolation.

    ``num_twirls`` > 0 reproduces the hardware pipeline's
    ``resilience_level=2`` semantics (``h31_submit_zne_hardware_100q_twirl``
    Options cells + pec_runtime twirling): every folded circuit is expanded
    into that many Pauli-twirl instances and their expectation values are
    averaged before extrapolation. Twirling converts coherent gate errors
    into stochastic Pauli noise, which folding amplifies multiplicatively —
    without it, folding a *coherent* error can rotate instead of damp the
    signal and ZNE extrapolates the wrong trend.
    """

    noise_factors: Tuple[float, ...] = (1, 3)
    gates_to_fold: Optional[int] = 2
    extrapolator: Union[Extrapolator, str] = dataclasses.field(
        default_factory=LinearExtrapolator)
    folding: str = "local"  # or "global"
    num_twirls: int = 0

    def __post_init__(self):
        if isinstance(self.extrapolator, str):
            table = {"linear": LinearExtrapolator,
                     "polynomial": PolynomialExtrapolator,
                     "richardson": RichardsonExtrapolator,
                     "exponential": ExponentialExtrapolator}
            try:
                self.extrapolator = table[self.extrapolator]()
            except KeyError:
                raise ValueError(
                    f"unknown extrapolator {self.extrapolator!r}; "
                    f"choose from {sorted(table)}") from None

    def amplify(self, circuit: Circuit, nf: float, seed: int = 0) -> Circuit:
        if nf == 1:
            return circuit
        if self.folding == "global":
            return fold_global(circuit, nf)
        return fold_gates(circuit, nf, self.gates_to_fold, seed)

    def amplify_twirled(self, circuit: Circuit, nf: float,
                        seed: int = 0) -> List[Circuit]:
        """Folded circuit expanded into ``num_twirls`` twirl instances.

        The twirl is sampled on the FOLDED circuit — each physical copy of
        a folded gate is twirled independently, exactly as hardware twirls
        the transpiled (already folded) circuit. With num_twirls == 0 this
        is just ``[amplify(...)]``.
        """
        folded = self.amplify(circuit, nf, seed)
        if self.num_twirls <= 0:
            return [folded]
        from .twirling import sample_twirled_circuits

        return sample_twirled_circuits(folded, self.num_twirls, seed=seed)


class ZNEEstimator(BaseEstimator):
    """Estimator wrapper running the full noise-factor sweep per circuit.

    All folded variants go to the base estimator in one batched call
    (replacing the reference's ``multiprocessing.Pool`` fan-out,
    ``zne_parallel.py:256-280``).
    """

    def __init__(self, base_estimator: BaseEstimator,
                 strategy: Optional[ZNEStrategy] = None):
        self._base = base_estimator
        self.strategy = strategy or ZNEStrategy()

    def _run(self, circuits, observables, parameter_values=None,
             **run_options) -> Job:
        strategy = run_options.pop("zne_strategy", self.strategy)
        circuits, observables = _normalize_run_args(
            circuits, observables, parameter_values)
        nfs = list(strategy.noise_factors)
        n_tw = max(strategy.num_twirls, 1)
        all_circs: List[Circuit] = []
        all_obs = []
        for ci, (qc, obs) in enumerate(zip(circuits, observables)):
            for nf in nfs:
                for inst in strategy.amplify_twirled(qc, nf, seed=ci):
                    all_circs.append(inst)
                    all_obs.append(obs)
        base_res = self._base.run(all_circs, all_obs,
                                  **run_options).result()
        # twirl-average before extrapolating (demo1's reshape(...).mean(-1))
        vals = np.asarray(base_res.values).reshape(
            len(circuits), len(nfs), n_tw).mean(axis=-1)
        out = np.array([strategy.extrapolator.extrapolate(nfs, row)
                        for row in vals])
        meta = [{"zne": {"noise_factors": nfs, "num_twirls": n_tw,
                         "measured": row.tolist()}} for row in vals]
        return Job(EstimatorResult(out, meta))


def zne(estimator_cls):
    """Class decorator parity with the ``zne(BackendEstimator)`` pattern:
    returns a class whose instances accept ``zne_strategy=`` in run()."""

    class ZNEWrapped(ZNEEstimator):
        def __init__(self, *args, zne_strategy=None, **kwargs):
            super().__init__(estimator_cls(*args, **kwargs), zne_strategy)

    ZNEWrapped.__name__ = f"ZNE{getattr(estimator_cls, '__name__', 'Estimator')}"
    return ZNEWrapped
