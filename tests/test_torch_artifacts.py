"""The schema gates, the paper-parity writer and the figures of the port
against the JAX package's shipped artifacts and ``figures``.

The demo1 and demo2 writers run at ``--fast`` in
``tests/test_torch_artifact_writers.py``.
"""
import copy
import json
import os

import numpy as np
import pytest

from mlqem_tpu.workflows import figures as jax_figures

from mlqem_tpu_torch.workflows import figures
from mlqem_tpu_torch.workflows.artifacts import main as write_artifact
from mlqem_tpu_torch.workflows.schemas import (check_demo1, check_demo2,
                                               check_paper_parity)

from port_fixtures import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = {
    "demo1": (check_demo1, "docs/demos/results/demo1_100q_simulated.json"),
    "demo2": (check_demo2, "docs/demos/results/demo2_4q_simulated.json"),
    "parity": (check_paper_parity, "docs/results/paper_parity_table.json"),
}


def _shipped(name):
    with open(os.path.join(ROOT, SHIPPED[name][1])) as f:
        return json.load(f)


@pytest.mark.parametrize("name", list(SHIPPED))
def test_gates_accept_the_shipped_artifacts(name):
    check = SHIPPED[name][0]
    check(_shipped(name), full=True)
    check(_shipped(name), full=False)


def _fast_demo1(t):
    t["protocol"]["fast"] = True


def _demo1_missing_arm(t):
    del t["rmse_per_step_vs_zne"]["mimic"]


def _demo1_short(t):
    for frame in ("rmse_per_step", "rmse_per_step_vs_zne"):
        for arm in t[frame]:
            t[frame][arm] = t[frame][arm][:4]


def _demo2_two_seeds(t):
    t["runs"] = t["runs"][:2]


def _demo2_losing_run(t):
    t["runs"][1]["rmse_mitigated"] = t["runs"][1]["rmse_noisy"] + 0.01


def _parity_missing_arm(t):
    del t["settings"]["coherent"]["ours_mean"]["gnn"]


def _parity_one_seed(t):
    t["seeds"] = t["seeds"][:1]
    for v in t["settings"].values():
        v["per_seed"] = v["per_seed"][:1]


# (artifact, doctoring, refused by the fast gate too)
DOCTORED = {
    "demo1_fast": ("demo1", _fast_demo1, False),
    "demo1_missing_arm": ("demo1", _demo1_missing_arm, True),
    "demo1_four_steps": ("demo1", _demo1_short, False),
    "demo2_two_seeds": ("demo2", _demo2_two_seeds, False),
    "demo2_losing_run": ("demo2", _demo2_losing_run, True),
    "parity_missing_arm": ("parity", _parity_missing_arm, True),
    "parity_one_seed": ("parity", _parity_one_seed, False),
}


@pytest.mark.parametrize("case", list(DOCTORED))
def test_gates_refuse_doctored_artifacts(case):
    name, doctor, fast_refuses = DOCTORED[case]
    t = copy.deepcopy(_shipped(name))
    doctor(t)
    check = SHIPPED[name][0]
    with pytest.raises((ValueError, KeyError)):
        check(t, full=True)
    if fast_refuses:
        with pytest.raises((ValueError, KeyError)):
            check(t, full=False)
    else:
        check(t, full=False)


def test_parity_writer_assembles_the_shipped_parts(tmp_path, capsys):
    """The writer reads the JAX package's per-(setting, seed) parts (a
    copy), writes the table and the figure under --out, and the table
    passes the full gate."""
    import shutil

    parts = tmp_path / "parts"
    shutil.copytree(os.path.join(ROOT, "docs", "results", "parts"), parts)
    out = tmp_path / "out"
    study = write_artifact(["parity", "--device", "cpu", "--parts-dir",
                            str(parts), "--out", str(out)])
    with open(out / "paper_parity_table.json") as f:
        written = json.load(f)
    check_paper_parity(written, full=True)
    assert (out / "paper_parity_figure.png").stat().st_size > 0
    shipped = _shipped("parity")
    for s, v in written["settings"].items():
        for m, val in v["ours_mean"].items():
            assert abs(val - shipped["settings"][s]["ours_mean"][m]) <= 1e-12
    assert study["run_info"]["fast"] is False
    assert "[incoherent]" in capsys.readouterr().out


def _plotted(fig):
    """Every line's (x, y), bar heights and scatter offsets of a figure."""
    out = []
    for ax in fig.axes:
        out += [np.asarray(line.get_xydata()) for line in ax.get_lines()]
        out += [np.asarray([p.get_height() for p in ax.patches])]
        out += [np.asarray(c.get_offsets()) for c in ax.collections]
        out += [np.asarray([t.get_text() for t in ax.get_xticklabels()])]
    return out


def _figure_inputs():
    rng = np.random.default_rng(3)
    table = {m: {"rmse_noisy": float(a), "rmse_mitigated": float(b)}
             for m, a, b in zip(("ols", "random_forest", "mlp1", "gnn"),
                                rng.uniform(0.05, 0.2, 4),
                                rng.uniform(0.01, 0.1, 4))}
    ideal, noisy, mit = rng.uniform(-1, 1, (3, 10, 4))
    parity = _shipped("parity")
    ptable = {s: {"ours": v["ours_mean"], "published": v["published"],
                  "ours_std": v["ours_std"]}
              for s, v in parity["settings"].items()}
    demo1 = _shipped("demo1")
    return {
        "figure_model_comparison": ((table,), {}),
        "figure_trotter_steps": ((list(range(10)), ideal, noisy, mit),
                                 {"qubit": 2}),
        "figure_zne_mimicry": ((ideal, noisy, mit, noisy * 0.5), {}),
        "figure_training_size_sweep": (
            ([{"train_size": 2 ** k, "rmse_mitigated": 0.1 / k,
               "rmse_noisy": 0.2} for k in range(1, 6)],), {}),
        "figure_paper_parity": ((ptable,), {}),
        "figure_demo1": ((demo1["rmse_per_step_vs_zne"],),
                         {"published": {"noisy": 0.06558,
                                        "mimic": 0.03482}}),
    }


@pytest.mark.parametrize("name", list(_figure_inputs()))
def test_figures_plot_what_jax_plots(name, tmp_path):
    import matplotlib.pyplot as plt

    args, kwargs = _figure_inputs()[name]
    got = getattr(figures, name)(*args, **kwargs,
                                 save_path=str(tmp_path / "port.png"))
    want = getattr(jax_figures, name)(*args, **kwargs)
    try:
        g, w = _plotted(got), _plotted(want)
        assert len(g) == len(w) and len(g) > 0
        for a, b in zip(g, w):
            assert a.shape == b.shape
            if a.dtype.kind in "fc":
                np.testing.assert_array_equal(a, b)
            else:
                assert (a == b).all()
        assert (tmp_path / "port.png").stat().st_size > 0
    finally:
        plt.close(got)
        plt.close(want)
