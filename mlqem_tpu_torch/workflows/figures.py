"""Paper-figure reproduction (``docs/paper_figures/plot.ipynb`` parity).

The port's own copy of ``mlqem_tpu/workflows/figures.py``: that module
imports no JAX, but the port imports nothing of the JAX package.

Generates the paper's figure shapes from freshly simulated result bundles:

* :func:`figure_model_comparison` — per-model RMSE bars (fig. 3 shape).
* :func:`figure_trotter_steps` — expectation values vs Trotter step for
  noisy / mitigated / ideal (fig. 4 / demo2 shape).
* :func:`figure_zne_mimicry` — noisy vs ZNE vs mimic scatter (fig. 6 /
  demo1 shape).
* :func:`figure_training_size_sweep` — accuracy vs training-set size
  (tomography study shape).

All return the matplotlib Figure and optionally save a PNG. matplotlib
is imported when a figure is drawn, and only there: a host without it
runs everything else (:func:`available` says whether it has it).
"""
from __future__ import annotations

import importlib.util
from typing import Dict, Optional, Sequence

import numpy as np


def available() -> bool:
    """Whether matplotlib is installed, so that figures can be drawn."""
    return importlib.util.find_spec("matplotlib") is not None


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def figure_model_comparison(table: Dict[str, Dict],
                            save_path: Optional[str] = None):
    plt = _plt()
    names = list(table)
    noisy = [table[n]["rmse_noisy"] for n in names]
    mit = [table[n]["rmse_mitigated"] for n in names]
    x = np.arange(len(names))
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.bar(x - 0.2, noisy, width=0.4, label="unmitigated")
    ax.bar(x + 0.2, mit, width=0.4, label="mitigated")
    ax.set_xticks(x)
    ax.set_xticklabels(names)
    ax.set_ylabel("RMSE vs ideal")
    ax.set_title("Mitigation model comparison")
    ax.legend()
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
    return fig


def figure_trotter_steps(steps: Sequence[int], ideal: np.ndarray,
                         noisy: np.ndarray, mitigated: np.ndarray,
                         qubit: int = 0,
                         save_path: Optional[str] = None):
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(steps, np.asarray(ideal)[:, qubit], "k-", label="ideal")
    ax.plot(steps, np.asarray(noisy)[:, qubit], "o--", label="noisy")
    ax.plot(steps, np.asarray(mitigated)[:, qubit], "s--",
            label="mitigated")
    ax.set_xlabel("Trotter steps")
    ax.set_ylabel(rf"$\langle Z_{qubit} \rangle$")
    ax.set_title("TFIM Trotter dynamics under mitigation")
    ax.legend()
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
    return fig


def figure_zne_mimicry(ideal: np.ndarray, noisy: np.ndarray,
                       zne: np.ndarray, mimic: np.ndarray,
                       save_path: Optional[str] = None):
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5, 5))
    lims = [-1.05, 1.05]
    ax.plot(lims, lims, "k-", lw=0.8)
    for vals, label, marker in ((noisy, "noisy", "."),
                                (zne, "ZNE", "x"),
                                (mimic, "RF mimic", "+")):
        ax.scatter(np.asarray(ideal).ravel(), np.asarray(vals).ravel(),
                   s=14, marker=marker, label=label, alpha=0.7)
    ax.set_xlabel("ideal expectation value")
    ax.set_ylabel("estimated expectation value")
    ax.set_title("ZNE mimicry")
    ax.legend()
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
    return fig


def figure_training_size_sweep(rows: Sequence[Dict],
                               save_path: Optional[str] = None):
    plt = _plt()
    sizes = [r["train_size"] for r in rows]
    mit = [r["rmse_mitigated"] for r in rows]
    noisy = [r["rmse_noisy"] for r in rows]
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.semilogx(sizes, mit, "o-", base=2, label="mitigated")
    ax.axhline(noisy[0], color="k", ls="--", label="noisy baseline")
    ax.set_xlabel("training-set size")
    ax.set_ylabel("RMSE vs ideal")
    ax.set_title("Accuracy vs training data")
    ax.legend()
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
    return fig


def figure_paper_parity(table: Dict[str, Dict],
                        save_path: Optional[str] = None):
    """Ours-vs-published RMSE bars per noise setting (the published
    single-Ising figure's table, ``paper_figures/*_single_ising.pk``).

    ``table``: {setting: {"ours": {...}, "published": {...}}} as produced
    by :func:`.paper_parity.single_ising_parity`; an
    optional per-setting ``"ours_std"`` dict (the v3 artifact's per-seed
    spread) draws error whiskers on the ours bars.
    """
    plt = _plt()
    settings = list(table)
    models = ["noisy", "random_forest", "mlp", "ols", "gnn", "zne"]
    fig, axes = plt.subplots(1, len(settings),
                             figsize=(4.5 * len(settings), 4), sharey=False)
    if len(settings) == 1:
        axes = [axes]
    for ax, s in zip(axes, settings):
        ours = [table[s]["ours"].get(m, np.nan) for m in models]
        pub = [table[s]["published"].get(m, np.nan) for m in models]
        std = table[s].get("ours_std")
        yerr = [std.get(m, 0.0) for m in models] if std else None
        x = np.arange(len(models))
        ax.bar(x - 0.2, ours, width=0.4, label="ours (simulated)",
               yerr=yerr, capsize=3 if yerr else 0)
        ax.bar(x + 0.2, pub, width=0.4, label="published (hardware)")
        ax.set_xticks(x)
        ax.set_xticklabels(models, rotation=30, ha="right")
        ax.set_title(s)
        ax.set_ylabel("RMSE vs ideal")
    axes[0].legend()
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
    return fig


def figure_demo1(per_step: Dict[str, Sequence[float]],
                 published: Optional[Dict[str, float]] = None,
                 save_path: Optional[str] = None,
                 ylabel: str = "RMSE vs ideal (test split)"):
    """demo1's per-step RMSE curves (noisy / ZNE / RF-mimic arms).

    ``per_step``: {"noisy"/"zne"/"mimic": [rmse per Trotter step]} as in
    ``demo1_zne_mimic_100q()["rmse_per_step"]``; ``published`` optionally
    draws the hardware campaign's aggregate anchors as horizontal lines
    (BASELINE.md demo1 rows: noisy 0.0656, mimic 0.0348).
    """
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6.5, 4))
    steps = np.arange(1, len(next(iter(per_step.values()))) + 1)
    styles = {"noisy": ("o-", "tab:red"), "zne": ("s--", "tab:orange"),
              "mimic": ("d-", "tab:blue")}
    for arm, vals in per_step.items():
        m, c = styles.get(arm, ("x-", None))
        ax.plot(steps, vals, m, color=c, label=arm)
    if published:
        for arm, v in published.items():
            ax.axhline(v, color="gray", lw=0.8, ls=":",
                       label=f"published {arm} (agg)")
    ax.set_xlabel("Trotter step")
    ax.set_ylabel(ylabel)
    ax.set_title("demo1: 100Q RF-mimics-ZNE, per-step RMSE")
    ax.legend()
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
    return fig
