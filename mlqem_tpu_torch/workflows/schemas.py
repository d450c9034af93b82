"""The schema gates of the three shipped artifacts.

Each ``check_*`` takes an artifact's parsed JSON and raises
:class:`ValueError` at the first assertion it fails.

* ``full=True`` is the JAX package's gate, assertion for assertion
  (``tests/test_workflows.py``: ``test_demo1_artifact_schema``,
  ``test_demo2_artifact_schema``, ``test_paper_parity_schema``): the
  artifact is the full protocol and lands in the published bands.
* ``full=False`` keeps the structure and the sanity checks and drops
  those of protocol size (``protocol.fast is False``, ``rows_count ==
  500``, the step, seed, setting and training-set counts), the
  published bands, and the parity table's bound of every learned arm
  within 1.2x the noisy one on every seed (a quality bound of the full
  training sizes: at ``--fast`` the MLP and GNN train on 60 circuits),
  so a ``--fast`` artifact of :mod:`.artifacts` can be held to it.
"""
from __future__ import annotations

from typing import Dict


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"artifact check failed: {what}")


def check_demo1(t: Dict, full: bool = True) -> None:
    """demo1 (``demo1_100q_simulated.json``): the light-cone engine,
    cross-checked against Pauli propagation, and mimicry against the
    noisy arm in the published (vs-ZNE) frame."""
    _require(t["engine"] == "lightcone", "engine is lightcone")
    _require(t["validated"] is True, "validated")
    _require(t["crosscheck"]["passed"] is True, "cross-check passed")
    _require("campaign protocol" in t["config"], "campaign protocol")
    steps = {len(vals) for frame in ("rmse_per_step", "rmse_per_step_vs_zne")
             for vals in t[frame].values()}
    _require(len(steps) == 1, f"one step count for every arm: {steps}")
    _require(set(t["rmse_per_step_vs_zne"]) == {"noisy", "mimic"},
             "vs-ZNE arms are noisy and mimic")
    _require(len(t["rmse_per_qubit_noisy"]) == 5, "5 observables")
    tv = t["truncation_validation"]
    _require(max(tv["K_values"]) >= 131072, "truncation audit at K 131072")
    _require(tv["validated_depth"] >= 6, "truncation audit depth >= 6")
    if not full:
        return
    _require(t["protocol"]["fast"] is False, "protocol.fast is False")
    # the 50k measurement budget split over ~1024 error realizations
    _require("1024 error realizations" in t["config"],
             "1024 error realizations")
    _require(t["rows_count"] == 500, "500 rows (50 circuits x 10 steps)")
    _require(steps == {10}, "10 Trotter steps")
    # the published demo1 metric: 0.0656 -> 0.0348 vs ZNE, 1.88x
    _require(t["rmse_mimic_vs_zne"] < t["rmse_noisy_vs_zne"],
             "mimic beats noisy vs ZNE")
    _require(t["improvement_vs_zne"] > 1.2, "improvement vs ZNE > 1.2")
    _require(abs(t["rmse_noisy_vs_zne"] - 0.06558) / 0.06558 < 0.5,
             "noisy vs ZNE within 50% of 0.06558")


def check_demo2(t: Dict, full: bool = True) -> None:
    """demo2 (``demo2_4q_simulated.json``): the seed study against the
    demo2 notebook's own hardware anchors (0.11713 -> 0.07471)."""
    _require(t["published_hardware_anchor"] == {"noisy": 0.11713,
                                                 "mitigated": 0.07471},
             "demo2's published anchors")
    _require(len(t["runs"]) >= 1, "at least one run")
    for r in t["runs"]:
        _require(r["rmse_mitigated"] < r["rmse_noisy"],
                 f"seed {r['seed']}: mitigated beats noisy")
    if not full:
        return
    _require(len(t["runs"]) >= 5, "5 seeds")
    _require(t["improvement_mean"] > 1.5, "mean improvement > 1.5 "
             "(published 1.57x)")


_PARITY_MODELS = {"noisy", "random_forest", "mlp", "ols", "gnn", "zne",
                  "zne_untwirled"}
_PARITY_SETTINGS = {"incoherent", "coherent", "no_readout"}


def check_paper_parity(t: Dict, full: bool = True) -> None:
    """The paper-parity table (``paper_parity_table.json``): every setting
    × column × seed of the faithful protocol, with per-seed sanity on
    every arm and, at ``full``, the published-family bands."""
    _require(t["schema"] == "paper_parity/v3", "schema paper_parity/v3")
    _require(t["protocol"] == "faithful", "faithful protocol")
    models = _PARITY_MODELS
    settings = set(t["settings"])
    _require(bool(settings) and settings <= _PARITY_SETTINGS,
             f"settings {sorted(settings)}")
    for s, v in t["settings"].items():
        _require(models <= set(v["ours_mean"]), f"{s}: every mean column")
        _require(models <= set(v["ours_std"]), f"{s}: every std column")
        _require(set(v["published"]) == {"noisy", "random_forest", "mlp",
                                         "ols", "gnn", "zne"},
                 f"{s}: the published columns")
        _require(len(v["per_seed"]) == len(t["seeds"]), f"{s}: every seed")
        for m in models - {"noisy"}:
            _require(v["improvement_ours"][m] > 0, f"{s}: {m} improvement")
        for run in v["per_seed"]:
            _require(run["ours"]["random_forest"] < run["ours"]["noisy"],
                     f"{s} seed {run['seed']}: RF beats noisy")
    if "coherent" in settings:
        _require(bool(t["settings"]["coherent"].get("theta_mult")),
                 "coherent channel is an over-rotation multiplier")
        coh = t["settings"]["coherent"]["improvement_ours"]
        # twirl->fold->extrapolate must not lose to plain folding
        _require(coh["zne"] >= coh["zne_untwirled"] - 0.05,
                 "coherent: twirled ZNE vs plain folding")
    if not full:
        return
    _require(len(t["seeds"]) >= 3, ">= 3 seeds")
    _require(settings == _PARITY_SETTINGS, "all three settings")
    for s, v in t["settings"].items():
        _require(v["num_train"] >= 1500, f"{s}: num_train >= 1500")
        for run in v["per_seed"]:
            # zne_untwirled is a diagnostic column, not a shipped arm
            for m in models - {"noisy", "zne_untwirled"}:
                _require(run["ours"][m] < 1.2 * run["ours"]["noisy"],
                         f"{s} seed {run['seed']}: {m} within 1.2x noisy")
        rel = abs(v["ours_mean"]["noisy"] - v["published"]["noisy"]) \
            / v["published"]["noisy"]
        _require(rel < 0.15, f"{s}: noisy within 15% of published")
    inc = t["settings"]["incoherent"]["improvement_ours"]
    _require(inc["random_forest"] >= 1.8, "incoherent: RF >= 1.8x")
    _require(inc["zne"] >= 1.1, "incoherent: ZNE >= 1.1x")
    coh = t["settings"]["coherent"]["improvement_ours"]
    pub = t["settings"]["coherent"]["improvement_published"]
    for m in ("random_forest", "ols", "mlp", "gnn"):
        _require(abs(coh[m] - pub[m]) / pub[m] < 0.35,
                 f"coherent: {m} within 35% of published")
    nor = t["settings"]["no_readout"]["improvement_ours"]
    _require(nor["random_forest"] >= 1.6 and nor["zne"] >= 1.1,
             "no_readout: RF >= 1.6x and ZNE >= 1.1x")
