"""Paper-parity benchmark: the published single-Ising figure, re-run.

Counterpart of ``mlqem_tpu/workflows/paper_parity.py``; datasets, forest
predictions, training and ZNE run on ``device`` (the card unless the
caller asks for the CPU). The part files of :func:`paper_parity_study`
have the JAX package's names and schema, so either package reads the
other's.

The reference ships its paper-figure result bundles
(``docs/paper_figures/{incoherent,coherent,no_readout}_single_ising.pk``)
with per-model mitigated expectation values on a 30-circuit 4Q TFIM test
set. Published RMSEs vs ideal (computed from those bundles):

    setting      noisy   RF      MLP     OLS(full)  GNN     ZNE
    incoherent   0.172   0.067   0.080   0.119      0.130   0.127
    coherent     0.268   0.234   0.266   0.242      0.243   0.264
    no_readout   0.151   0.060   0.090   0.120      0.128   0.116

:func:`single_ising_parity` reproduces the experiment shape end-to-end on
this framework's simulators (train on randomized (J, steps) Trotter
circuits, test on a deeper step sweep, 10k shots) and reports our RMSE
table next to the published anchors. The simulated noise regime is
calibrated to the published noisy baseline via a global channel-strength
multiplier (:func:`calibrate_noise_scale` → :data:`CALIBRATED_SCALE`), so
every column is a like-for-like comparison, not just the improvement
factors. :func:`paper_parity_study` is the one-command reproducible
artifact generator (all settings × seeds, full precision — the
``docs/results/paper_parity_table.json`` producer).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from ..circuits.families import IsingOptions
from ..device.model import DeviceModel
from ..device.noise import add_coherent_cx_noise
from ..device.registry import get_device
from ..metrics import rmse
from ..models.forest import RandomForestRegressor
from ..models.linear import LinearRegression
from ..models.mlp import MLP1
from .datasets import Device, ising_dataset, ising_step_sweep, noise_setting
from .mitigate import encode_dataset, zne_batch

PUBLISHED = {
    "incoherent": {"noisy": 0.172, "random_forest": 0.067, "mlp": 0.080,
                   "ols": 0.119, "gnn": 0.130, "zne": 0.127},
    "coherent": {"noisy": 0.268, "random_forest": 0.234, "mlp": 0.266,
                 "ols": 0.242, "gnn": 0.243, "zne": 0.264},
    "no_readout": {"noisy": 0.151, "random_forest": 0.060, "mlp": 0.090,
                   "ols": 0.120, "gnn": 0.128, "zne": 0.116},
}

_SETTING_MAP = {"incoherent": "device", "coherent": "coherent",
                "no_readout": "no_readout"}

# Provenance stamp written into every single_ising_parity result (and
# so every resume part), the JAX package's: paper_parity_study refuses a
# part of another version unless redo_arms covers the change. Version 2:
# faithful MLP lr 3e-4 + [-1,1] clip; GNN [-1,1] clip; per-qubit RF(300);
# v2 MLP at lr 3e-3.
ARMS_VERSION = 2

# Global channel-strength multipliers that calibrate_noise_scale() fitted
# in the JAX package so the NOISY arm of the v2 protocol reproduces the
# published noisy RMSE per setting (its fits: noisy RMSE 0.1701 / 0.2657 /
# 0.1514 against published 0.172 / 0.268 / 0.151).
CALIBRATED_SCALE: Dict[str, float] = {
    "incoherent": 4.0876,
    "coherent": 4.0876,
    "no_readout": 5.4760,
}

# The faithful protocol's calibration (see ``single_ising_parity``'s
# ``protocol`` doc), fitted in the JAX package by bisection: incoherent
# channel scales on the routed faithful test sweep, plus (coherent setting
# only) a multiplier on the reference's over-rotation bound θ=0.04π
# (``h13``: ``AddNoise().add_coherent_noise(seed=0, theta=np.pi*0.04)``),
# which keeps the marginal noise coherent. Its fits: noisy RMSE 0.1713 /
# 0.2671 / 0.1520 against published 0.172 / 0.268 / 0.151.
FAITHFUL_THETA = 0.04 * np.pi
FAITHFUL_SCALE: Dict[str, Dict[str, float]] = {
    "incoherent": {"scale": 0.9473},
    "coherent": {"scale": 0.9473, "theta_mult": 1.2898},
    "no_readout": {"scale": 0.8318},
}


def _experiment_noise(setting: str, device_model: DeviceModel,
                      noise_scale: Optional[float],
                      noise_seed: int = 0,
                      protocol: str = "v2",
                      theta_mult: Optional[float] = None):
    """ONE noise-model realization for a whole experiment.

    Train, test and ZNE stages must see the same channels — the coherent
    setting's per-edge over-rotation angles are random, and resampling
    them per stage would both break model transfer and mis-state what the
    models learned.
    """
    if protocol == "faithful":
        cal = FAITHFUL_SCALE.get(setting, {"scale": 1.0})
        scale = float(noise_scale if noise_scale is not None
                      else cal["scale"])
        if setting == "coherent":
            mult = float(theta_mult if theta_mult is not None
                         else cal["theta_mult"])
            return add_coherent_cx_noise(
                device_model, theta=FAITHFUL_THETA * mult, uniform=False,
                add_depolarization=True, add_coherent=True,
                seed=noise_seed, scale=scale), scale
        return noise_setting(device_model, _SETTING_MAP[setting],
                             seed=noise_seed, scale=scale), scale
    if noise_scale is None:
        noise_scale = CALIBRATED_SCALE.get(setting, 1.0)
    return noise_setting(device_model, _SETTING_MAP[setting],
                         seed=noise_seed, scale=noise_scale), \
        float(noise_scale)


def single_ising_parity(setting: str = "incoherent",
                        device_model: Optional[DeviceModel] = None,
                        num_train: Optional[int] = None,
                        max_steps: int = 30,
                        num_test_steps: int = 30,
                        shots: Optional[int] = 10000,
                        mlp_epochs: int = 200,
                        gnn_epochs: int = 400,
                        gnn_train_max: int = 1200,
                        run_zne: bool = True,
                        num_twirls: int = 8,
                        noise_scale: Optional[float] = None,
                        theta_mult: Optional[float] = None,
                        noise_seed: int = 0,
                        protocol: str = "faithful",
                        arms: Optional[Sequence[str]] = None,
                        seed: int = 0,
                        device: Device = "cuda") -> Dict:
    """Re-run the single-Ising experiment; returns ours-vs-published RMSEs.

    ``arms`` limits which model arms run (subset of ``{"random_forest",
    "ols", "mlp", "gnn", "zne"}``; ``None`` = all). The datasets are
    seeded and deterministic, so a filtered re-run reproduces exactly the
    arm a full run would have produced — this is what
    :func:`paper_parity_study`'s ``redo_arms`` uses to patch a single arm
    inside an hours-scale cached artifact without recomputing the rest.

    ``protocol`` selects the experiment shape:

    * ``"faithful"`` (default) — the reference's actual published-table
      protocol, decoded from ``h13_ising_data_gen.ipynb`` +
      ``coherent_single_ising.pk``: every circuit carries the paper's
      fixed random init block and is lowered to the IBM basis (features =
      transpiled gate counts, ``h13`` ``transpile(..., opt=3)``); train =
      ``num_train`` (default 4500 = the reference's 300/step × 15) circuits
      with J ~ U[0, 1], basis ~ {X,Y,Z}, steps ~ U{0..14}; test = the
      FIXED J=0.15 Z-basis sweep over steps 0..29 (so half the test is
      depth EXTRAPOLATION); ideal labels are 10k-shot sampled (the
      reference's ideal arm is QasmSimulator counts); the RF arm is the
      per-qubit ``RandomForestRegressor(300)`` list (``h15`` cell 11).
      This distribution shift is what makes the published coherent setting
      nearly ML-resistant (RF 1.145×): interference-dominated errors do
      not transfer from the random-(J, basis) train family to the fixed
      test sweep.
    * ``"v2"`` — round-2/3's interpolation protocol (train and test share
      the Z-basis family and J grid, exact ideal labels, multi-output RF).
      Kept because its regime is a like-for-like RMSE comparison per arm;
      its improvement factors overstate learnability in the coherent
      setting.

    ``noise_scale=None`` uses the calibrated per-setting scale
    (:data:`CALIBRATED_SCALE` / :data:`FAITHFUL_SCALE`) so the noisy
    baseline matches the published regime. The ``zne`` arm composes Pauli
    twirling with folding (``num_twirls`` instances per folded circuit —
    the hardware pipeline's resilience_level=2 semantics, ``h31`` Options
    cells); ``zne_untwirled`` records what plain folding alone would give
    (the reference's simulated ZNE, ``zne_parallel.py:176-188``).
    """
    if protocol not in ("faithful", "v2"):
        raise ValueError(f"unknown protocol {protocol!r}")
    faithful = protocol == "faithful"
    all_arms = {"random_forest", "ols", "mlp", "gnn", "zne"}
    arms = all_arms if arms is None else set(arms)
    if not arms <= all_arms:
        raise ValueError(f"unknown arms {sorted(arms - all_arms)}")

    import sys as _sys
    import time as _time
    _t0 = _time.time()

    def _mark(phase: str) -> None:
        # per-phase wall prints: the artifact run is hours-scale
        print(f"[parity {setting} s{seed}] {phase}: "
              f"{_time.time() - _t0:.0f}s total", file=_sys.stderr,
              flush=True)

    device_model = device_model or get_device("fake_lima")
    nm, noise_scale = _experiment_noise(setting, device_model, noise_scale,
                                        noise_seed, protocol=protocol,
                                        theta_mult=theta_mult)
    ops = IsingOptions.config_4q_paper()
    if num_train is None:
        num_train = 4500 if faithful else 200
    need_train = bool(arms & {"random_forest", "ols", "mlp", "gnn"})
    train = None
    if faithful:
        if need_train:
            train = ising_dataset(device_model, options=ops,
                                  num_circuits=num_train,
                                  steps_range=(0, 15), J_range=(0.0, 1.0),
                                  bases=("X", "Y", "Z"), noise=nm,
                                  shots=shots, init_prefix=True, lower=True,
                                  route=True, ideal_shots=shots, seed=seed,
                                  device=device)
        test = ising_step_sweep(device_model, ops, num_test_steps - 1,
                                noise=nm, shots=shots, init_prefix=True,
                                lower=True, route=True, ideal_shots=shots,
                                seed=seed + 1, device=device)
    else:
        if need_train:
            train = ising_dataset(device_model, options=ops,
                                  num_circuits=num_train,
                                  steps_range=(0, max_steps + 1), noise=nm,
                                  shots=shots, seed=seed, device=device)
        test = ising_step_sweep(device_model, ops, num_test_steps, noise=nm,
                                shots=shots, seed=seed + 1, device=device)
    _mark("datagen")
    if need_train:
        Xtr, ytr = encode_dataset(train, device_model)
    Xte, yte = encode_dataset(test, device_model)

    ours: Dict[str, float] = {"noisy": float(rmse(test.noisy, test.ideal))}

    if "random_forest" not in arms:
        pass
    elif faithful:
        # per-qubit RF(300) list — h15 cell 11
        pred = np.zeros_like(yte)
        for q in range(yte.shape[1]):
            rf = RandomForestRegressor(n_estimators=300,
                                       random_state=seed + q, device=device)
            rf.fit(Xtr, ytr[:, q])
            pred[:, q] = rf.predict(Xte)
        ours["random_forest"] = float(rmse(pred, yte))
        _mark("rf")
    else:
        rf = RandomForestRegressor(n_estimators=300, random_state=seed,
                                   device=device)
        rf.fit(Xtr, ytr)
        ours["random_forest"] = float(rmse(rf.predict(Xte), yte))

    if "ols" in arms:
        ols = LinearRegression(device=device).fit(Xtr, ytr)
        ours["ols"] = float(rmse(ols.predict(Xte), yte))

    from ..models.train import mlp_inputs, predict, train_mlp

    if "mlp" in arms:
        # Faithful: lr 3e-4 — half the faithful test sweep is depth
        # EXTRAPOLATION (train steps 0-14, test 0-29); at lr>=1e-3 the MLP
        # fits the in-range region sharply (val 0.007) and its ReLU
        # features extrapolate wildly at the unseen depths (test RMSE 0.94
        # at num_train=1500, lr 3e-3); 3e-4 lands the published behavior
        # exactly (coherent test RMSE 0.265 vs published 0.266). The
        # [-1, 1] clip is the physical bound on any expectation value.
        # v2 keeps its original lr 3e-3 (interpolation protocol; the r2/r3
        # baselines were measured there and must stay reproducible).
        mlp = MLP1(hidden_size=64, output_size=4, input_size=Xtr.shape[1])
        state_dict, _ = train_mlp(mlp, Xtr, ytr, num_epochs=mlp_epochs,
                                  batch_size=32,
                                  learning_rate=3e-4 if faithful else 3e-3,
                                  seed=seed, device=device)
        mpred = np.clip(predict(mlp, state_dict, mlp_inputs,
                                {"X": Xte.astype(np.float32)}), -1.0, 1.0)
        ours["mlp"] = float(rmse(mpred, yte))
        _mark("mlp")

    if "gnn" in arms:
        ours["gnn"], n_tr = _gnn_arm(train, test, device_model, yte,
                                     faithful, gnn_train_max, gnn_epochs,
                                     seed, device=device)
        _mark("gnn")

    if run_zne and "zne" in arms:
        zne_vals = zne_batch(test, device_model, noise=nm, shots=shots,
                             seed=seed + 2, num_twirls=num_twirls,
                             device=device)
        ours["zne"] = float(rmse(zne_vals, test.ideal))
        plain = zne_batch(test, device_model, noise=nm, shots=shots,
                          seed=seed + 2, num_twirls=0, device=device)
        ours["zne_untwirled"] = float(rmse(plain, test.ideal))
        _mark("zne")

    pub = PUBLISHED[setting]
    out = {
        "setting": setting,
        "protocol": protocol,
        "arms_version": ARMS_VERSION,
        "num_train": num_train,
        "noise_scale": noise_scale,
        "num_twirls": num_twirls,
        "seed": seed,
        "ours": ours,
        "published": pub,
        "improvement_ours": {k: ours["noisy"] / v
                             for k, v in ours.items() if k != "noisy"},
        "improvement_published": {k: pub["noisy"] / v
                                  for k, v in pub.items() if k != "noisy"},
    }
    if faithful:
        if "gnn" in arms:
            out["gnn_train_count"] = n_tr
        if setting == "coherent":
            out["theta_mult"] = float(
                theta_mult if theta_mult is not None
                else FAITHFUL_SCALE["coherent"]["theta_mult"])
    return out


def _gnn_arm(train, test, device_model, yte, faithful: bool,
             gnn_train_max: int, gnn_epochs: int, seed: int,
             return_pred: bool = False, device: Device = "cuda"):
    """GNN arm (ref gnn.py:178-224): graph-encode train+test together so
    padded node/edge widths match, train on the train block, eval on
    test. Returns (rmse, gnn_train_count), plus the clipped test
    predictions when ``return_pred`` (per-step diagnostics)."""
    from ..models.gnn import ExpValCircuitGraphModel3
    from ..models.train import gnn_inputs, predict, train_gnn
    from .datasets import LabeledDataset
    from .mitigate import graph_encode_dataset

    gtrain = train
    if faithful and len(train) > gnn_train_max:
        # the dense-masked GNN over 4500 lowered (~900-node) graphs is the
        # one arm that cannot afford the full faithful train set on the
        # CPU artifact runner — train it on a seeded subsample and record
        # the count in the artifact config
        sub = np.random.default_rng(seed).choice(
            len(train), size=gnn_train_max, replace=False)
        gtrain = LabeledDataset([train.circuits[i] for i in sub],
                                train.ideal[sub], train.noisy[sub],
                                [train.meta[i] for i in sub])
    combined = LabeledDataset(
        list(gtrain.circuits) + list(test.circuits),
        np.concatenate([gtrain.ideal, test.ideal]),
        np.concatenate([gtrain.noisy, test.noisy]),
        list(gtrain.meta) + list(test.meta))
    n_tr = len(gtrain)
    gall = graph_encode_dataset(combined, device_model, stats_count=n_tr)
    gnn = ExpValCircuitGraphModel3(hidden_channels=15, exp_value_size=4,
                                   dropout=0.0,
                                   num_node_features=gall["x"].shape[-1])
    gvars, _ = train_gnn(
        gnn, {**{k: v[:n_tr] for k, v in gall.items()},
              "y": gtrain.ideal.astype(np.float32)},
        num_epochs=gnn_epochs, batch_size=32, learning_rate=2e-3, seed=seed,
        device=device)
    gpred = predict(gnn, gvars, gnn_inputs,
                    {k: v[n_tr:] for k, v in gall.items()})
    # [-1, 1] clip: the physical bound on an expectation value — same
    # guard the MLP arm carries (half the faithful test sweep is depth
    # EXTRAPOLATION past the trained steps, where an unbounded head can
    # wander; clipping toward the feasible set never hurts RMSE here)
    gpred = np.clip(gpred, -1.0, 1.0)
    if return_pred:
        return float(rmse(gpred, yte)), n_tr, gpred
    return float(rmse(gpred, yte)), n_tr


def noisy_rmse_at_scale(setting: str, scale: float,
                        device_model: Optional[DeviceModel] = None,
                        num_test_steps: int = 30,
                        shots: Optional[int] = 10000,
                        noise_seed: int = 0, seed: int = 0,
                        protocol: str = "v2",
                        theta_mult: Optional[float] = None,
                        device: Device = "cuda") -> float:
    """The parity protocol's NOISY-arm RMSE at one noise scale (the
    calibration objective — same test set as :func:`single_ising_parity`).

    Under ``protocol="faithful"`` + ``setting="coherent"``, pass the scale
    as ``theta_mult`` via the keyword and keep ``scale`` at the calibrated
    incoherent value — :func:`calibrate_coherent_theta` wraps this.
    """
    device_model = device_model or get_device("fake_lima")
    nm, _ = _experiment_noise(setting, device_model, scale, noise_seed,
                              protocol=protocol, theta_mult=theta_mult)
    if protocol == "faithful":
        test = ising_step_sweep(device_model, IsingOptions.config_4q_paper(),
                                num_test_steps - 1, noise=nm, shots=shots,
                                init_prefix=True, lower=True, route=True,
                                ideal_shots=shots, seed=seed + 1,
                                device=device)
    else:
        test = ising_step_sweep(device_model, IsingOptions.config_4q_paper(),
                                num_test_steps, noise=nm, shots=shots,
                                seed=seed + 1, device=device)
    return float(rmse(test.noisy, test.ideal))


def calibrate_coherent_theta(target: Optional[float] = None,
                             device_model: Optional[DeviceModel] = None,
                             lo: float = 0.5, hi: float = 16.0,
                             iters: int = 10, tol: float = 0.01,
                             **kwargs) -> Dict:
    """Fit the faithful protocol's coherent θ multiplier: bisection on
    ``theta_mult`` at the FIXED incoherent scale so the noisy arm hits the
    published coherent baseline with the marginal noise kept coherent."""
    target = target if target is not None else PUBLISHED["coherent"]["noisy"]
    device_model = device_model or get_device("fake_lima")
    inc_scale = FAITHFUL_SCALE["coherent"]["scale"]
    history = []

    def f(m):
        r = noisy_rmse_at_scale("coherent", inc_scale, device_model,
                                protocol="faithful", theta_mult=m, **kwargs)
        history.append({"theta_mult": float(m), "rmse": float(r)})
        return r

    r_lo, r_hi = f(lo), f(hi)
    if not (r_lo <= target <= r_hi):
        raise ValueError(f"target {target} outside [{r_lo:.4f}, {r_hi:.4f}]")
    llo, lhi = np.log(lo), np.log(hi)
    mid, r_mid = lo, r_lo
    for _ in range(iters):
        mid = float(np.exp((llo + lhi) / 2))
        r_mid = f(mid)
        if abs(r_mid - target) / target <= tol:
            break
        if r_mid < target:
            llo = np.log(mid)
        else:
            lhi = np.log(mid)
    return {"theta_mult": float(mid), "rmse": float(r_mid),
            "target": float(target), "inc_scale": float(inc_scale),
            "history": history}


def calibrate_noise_scale(setting: str,
                          target: Optional[float] = None,
                          device_model: Optional[DeviceModel] = None,
                          lo: float = 0.25, hi: float = 16.0,
                          iters: int = 12, tol: float = 0.02,
                          **kwargs) -> Dict:
    """Fit the global channel-strength scale so the noisy-arm RMSE matches
    the published noisy baseline (bisection in log-scale; RMSE is monotone
    increasing in scale).

    Returns {"scale", "rmse", "target", "history"}; ``tol`` is relative.
    """
    target = target if target is not None else PUBLISHED[setting]["noisy"]
    device_model = device_model or get_device("fake_lima")
    history = []

    def f(s):
        r = noisy_rmse_at_scale(setting, s, device_model, **kwargs)
        history.append({"scale": float(s), "rmse": float(r)})
        return r

    r_lo, r_hi = f(lo), f(hi)
    if not (r_lo <= target <= r_hi):
        raise ValueError(
            f"target {target} outside achievable range "
            f"[{r_lo:.4f}, {r_hi:.4f}] for scales [{lo}, {hi}]")
    llo, lhi = np.log(lo), np.log(hi)
    mid, r_mid = lo, r_lo
    for _ in range(iters):
        mid = float(np.exp((llo + lhi) / 2))
        r_mid = f(mid)
        if abs(r_mid - target) / target <= tol:
            break
        if r_mid < target:
            llo = np.log(mid)
        else:
            lhi = np.log(mid)
    return {"setting": setting, "scale": float(mid), "rmse": float(r_mid),
            "target": float(target), "history": history}


def paper_parity_study(settings: Sequence[str] = ("incoherent", "coherent",
                                                  "no_readout"),
                       seeds: Sequence[int] = (0, 1, 2),
                       parts_dir: Optional[str] = None,
                       redo_arms: Optional[Sequence[str]] = None,
                       **kwargs) -> Dict:
    """The complete, reproducible paper-parity artifact: every setting ×
    seed through :func:`single_ising_parity`, aggregated to mean ± std with
    improvement factors, next to the published anchors.

    ``parts_dir`` caches each finished (setting, seed) run as JSON so a
    killed run resumes instead of recomputing — the same pattern as
    demo1's per-(arm, j-chunk) parts. The part files have the JAX
    package's names and schema, so either package reads the other's.
    ``kwargs`` go to :func:`single_ising_parity` (``device=`` among
    them).

    ``redo_arms`` re-runs just those arms (e.g. ``["mlp"]``) inside every
    CACHED part and rewrites it — the surgical fix path when one arm of an
    hours-scale artifact needs a patch (datasets are seeded, so the other
    arms' numbers stay exactly what a full re-run would give). Non-cached
    (setting, seed) cells still run in full.

    The JAX package's ``docs/results/make_paper_parity.py`` runs its
    counterpart; the schema (``paper_parity/v3`` for the faithful
    protocol) is the same.
    """
    import json
    import os
    import sys
    import time

    protocol = kwargs.get("protocol", "faithful")
    out: Dict = {"schema": "paper_parity/v3" if protocol == "faithful"
                 else "paper_parity/v2",
                 "protocol": protocol, "seeds": list(seeds),
                 "settings": {}}
    if parts_dir:
        os.makedirs(parts_dir, exist_ok=True)
    for setting in settings:
        runs = []
        for s in seeds:
            part = (os.path.join(parts_dir, f"{protocol}_{setting}_s{s}.json")
                    if parts_dir else None)
            if part and os.path.exists(part):
                with open(part) as f:
                    run = json.load(f)
                ver = run.get("arms_version")
                if ver != ARMS_VERSION and not redo_arms:
                    # refuse to fold a stale-arm part into the artifact —
                    # the operator must either redo the changed arms
                    # (rewrites the part with the current stamp) or delete
                    # the part for a full re-run (ADVICE r4)
                    raise RuntimeError(
                        f"cached part {part} has arms_version {ver}, code "
                        f"is {ARMS_VERSION} — pass redo_arms for the "
                        f"changed arms or delete the part")
                if redo_arms:
                    patch = single_ising_parity(setting, seed=s,
                                                arms=redo_arms, **kwargs)
                    # determinism guard: the re-run's seeded noisy arm must
                    # reproduce the cached one (platform ulp drift at most)
                    rel = abs(patch["ours"]["noisy"] - run["ours"]["noisy"]
                              ) / run["ours"]["noisy"]
                    if rel > 0.02:
                        raise RuntimeError(
                            f"redo_arms noisy mismatch ({setting} s{s}): "
                            f"{patch['ours']['noisy']:.4f} vs cached "
                            f"{run['ours']['noisy']:.4f} — config drifted")
                    for k, v in patch["ours"].items():
                        if k != "noisy":
                            run["ours"][k] = v
                    run["improvement_ours"] = {
                        k: run["ours"]["noisy"] / v
                        for k, v in run["ours"].items() if k != "noisy"}
                    if "gnn_train_count" in patch:
                        run["gnn_train_count"] = patch["gnn_train_count"]
                    run["arms_version"] = patch["arms_version"]
                    with open(part, "w") as f:
                        json.dump(run, f)
                    print(f"[paper_parity] {setting} seed={s}: redo "
                          f"{sorted(redo_arms)} -> " +
                          str({k: round(v, 4)
                               for k, v in patch["ours"].items()}),
                          file=sys.stderr, flush=True)
                runs.append(run)
                print(f"[paper_parity] {setting} seed={s}: cached ({part})",
                      file=sys.stderr, flush=True)
                continue
            t0 = time.time()
            runs.append(single_ising_parity(setting, seed=s, **kwargs))
            if part:
                with open(part, "w") as f:
                    json.dump(runs[-1], f)
            print(f"[paper_parity] {setting} seed={s}: "
                  f"{time.time() - t0:.0f}s "
                  f"noisy={runs[-1]['ours']['noisy']:.4f} "
                  f"rf={runs[-1]['ours']['random_forest']:.4f}",
                  file=sys.stderr, flush=True)
        models = sorted(runs[0]["ours"])
        mean = {m: float(np.mean([r["ours"][m] for r in runs]))
                for m in models}
        std = {m: float(np.std([r["ours"][m] for r in runs]))
               for m in models}
        out["settings"][setting] = {
            "noise_scale": runs[0]["noise_scale"],
            "num_twirls": runs[0]["num_twirls"],
            "num_train": runs[0].get("num_train"),
            **({"theta_mult": runs[0]["theta_mult"]}
               if "theta_mult" in runs[0] else {}),
            "published": PUBLISHED[setting],
            "ours_mean": mean,
            "ours_std": std,
            "improvement_ours": {m: mean["noisy"] / mean[m]
                                 for m in models if m != "noisy"},
            "improvement_published": {
                k: PUBLISHED[setting]["noisy"] / v
                for k, v in PUBLISHED[setting].items() if k != "noisy"},
            "per_seed": [{"seed": r["seed"], "ours": r["ours"]}
                         for r in runs],
        }
    return out
