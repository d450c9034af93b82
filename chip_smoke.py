#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the float32 matmul settings, which must be IEEE f32 (no TF32);
2. build both kernels at once from ``mlqem_tpu_torch/csrc/evolve.cu`` (K1)
   and ``mlqem_tpu_torch/csrc/frame_evolve.cu`` (K2), one ``nvcc`` each;
3. hold the kernel against its plain PyTorch version on the card
   (nq 6, 8, 10; 4 steps; ragged row counts; max|Δ| ≤ 1e-5) and time both
   at the main path's noisy-arm shape (nq=10, 524,288 rows);
4. run the kicked-Ising label generator at the bench configuration
   (``configurable_device(10, seed=0)``, 4 steps, dt 0.25, 16,384 circuits
   × 32 trajectories, 10,000 shots) through the kernel: the launch count
   must rise by 2, the labels must be finite, of shape (16384, 10) and in
   [−1, 1], the ideal labels must match an independent numpy statevector
   simulation, and, with ``shots=None``, the kernel path must match the
   plain path to 1e-5;
5. time whole batches (pairs/min), the stages, and peak device memory;
6. hold K2 against its plain PyTorch version (max|Δ| ≤ 2e-5) on random
   plans of every op kind (nq 2, 5, 10, 13; ragged row counts) and on the
   bench template's plan (nq 10, 4 steps: 148 ops) at 16,384 rows, and time
   both at the frame pipeline's shape (262,144 rows);
7. run the generic Pauli-frame label pipeline at ``bench.py --method
   frame``'s configuration (``IsingLabelPipeline(method="frame")``: 8192
   circuits × 32 trajectories, nq 10, 4 steps, 10,000 shots) through K2:
   one K2 launch per batch, labels finite, of shape (8192, 10) and in
   [−1, 1], ideal labels matching the numpy statevector, the kernel path
   matching the plain path with ``shots=None``, and the batch-mean noisy
   ⟨Z_q⟩ matching the kicked-Ising engine's within 5 standard errors;
8. time the frame pipeline: pairs/min, the stages, peak device memory.

The line before the last is the card as ``nvidia-smi`` gives it; the one
before that holds the kernels' JSON record. The last line is
``{"ok": true, "device": {...}}``.
"""
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
NQ, STEPS, DT, N_TRAJ, SHOTS, BATCH = 10, 4, 0.25, 32, 10000, 16384
NOISY_ROWS = BATCH * N_TRAJ
TOL = 1e-5
FRAME_BATCH = 8192                    # bench.py's default for --method frame
FRAME_ROWS = FRAME_BATCH * N_TRAJ
K2_CHECK_ROWS = 16384                 # the bench plan's check against plain
K2_TOL = 2e-5


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def require(ok, msg):
    if not ok:
        fail(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(out.returncode == 0 and out.stdout.strip(),
            f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def kernel_inputs(nq, rows, seed, device):
    """±1 signs and θJ from numpy; |0…0⟩ starts made on the device."""
    import numpy as np
    import torch

    from mlqem_tpu_torch.ops.kicked_ising import _sign_tables

    rng = np.random.default_rng(seed)
    bit_pm, bond_par = _sign_tables(nq)
    nb = bond_par.shape[1]

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)

    re = torch.zeros((rows, 2 ** nq), device=device)
    re[:, 0] = 1.0
    args = [re, torch.zeros_like(re),
            dev(rng.choice([-1.0, 1.0], size=(rows, STEPS * nq))),
            dev(rng.choice([-1.0, 1.0], size=(rows, STEPS * nb))),
            dev(rng.uniform(-1.2, -0.1, size=(rows, 1))),
            dev(bit_pm.T), dev(bond_par.T)]
    return args, nb


def time_ms(fn, reps):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_kernel_and_plain(run_kernel, run_plain, plain_reps):
    """Plain, kernel, kernel, plain on the same card: (best kernel ms, best
    plain ms, the kernel runs, the plain runs)."""
    plain_ms = [time_ms(run_plain, plain_reps)]
    kernel_ms = [time_ms(run_kernel, 5), time_ms(run_kernel, 5)]
    plain_ms.append(time_ms(run_plain, plain_reps))
    return min(kernel_ms), min(plain_ms), kernel_ms, plain_ms


def time_batches(generate, J, rng, card, label):
    """pairs/min over 5 ``generate`` batches after a warm-up, each ending
    in the host copy, and the peak device memory over them."""
    import numpy as np
    import torch

    generate(J, seed=1)                             # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    batch_s = []
    for seed in range(2, 7):
        Jb = rng.uniform(0.05, 0.6, size=len(J)).astype(np.float32)
        t0 = time.perf_counter()
        generate(Jb, seed=seed)                     # ends in a host copy
        batch_s.append(time.perf_counter() - t0)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    med = statistics.median(batch_s)
    print(f"{label}pairs/min: {len(J) * 60.0 / med:.0f} (median of "
          f"{len(batch_s)} batches, {med * 1e3:.1f} ms/batch; best "
          f"{len(J) * 60.0 / min(batch_s):.0f}; batches "
          f"{[round(s * 1e3, 1) for s in batch_s]} ms) [{card}]")
    print(f"{label}peak device memory: {peak_gib:.2f} GiB "
          f"(torch.cuda.max_memory_allocated) [{card}]")


def stage_split(run, device):
    """Median ms of each stage over 3 batches, with a synchronize at each
    stage mark: ``run(generator, mark)`` runs one batch."""
    import torch

    stage_ms = {}
    for seed in range(7, 10):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        torch.cuda.synchronize()
        last = [time.perf_counter()]

        def mark(stage):
            torch.cuda.synchronize()
            now = time.perf_counter()
            stage_ms.setdefault(stage, []).append((now - last[0]) * 1e3)
            last[0] = now

        run(gen, mark)
    return {k: statistics.median(v) for k, v in stage_ms.items()}


def exact_ideal_z(J, nq, steps, dt, h=1.0):
    """Independent check: ⟨Z_q⟩ of the Trotter circuit by complex128
    statevector simulation, gate by gate (RX(2h·dt) on every qubit, then
    RZZ(−2J·dt) on the even and then the odd bonds)."""
    import numpy as np

    dim = 2 ** nq
    bits = (np.arange(dim)[:, None] >> np.arange(nq)[None, :]) & 1
    z = 1.0 - 2.0 * bits                              # Z_q eigenvalues
    c, s = np.cos(h * dt), np.sin(h * dt)             # RX(θ), θ/2 = h·dt
    bonds = ([(q, q + 1) for q in range(0, nq - 1, 2)]
             + [(q, q + 1) for q in range(1, nq - 1, 2)])
    out = []
    for jv in J:
        psi = np.zeros(dim, np.complex128)
        psi[0] = 1.0
        for _ in range(steps):
            for q in range(nq):
                v = psi.reshape(dim // 2 ** (q + 1), 2, 2 ** q)
                a, b = v[:, 0, :].copy(), v[:, 1, :].copy()
                v[:, 0, :] = c * a - 1j * s * b
                v[:, 1, :] = -1j * s * a + c * b
            for qa, qb in bonds:
                theta = -2.0 * float(jv) * dt
                psi = psi * np.exp(-0.5j * theta * z[:, qa] * z[:, qb])
        out.append((np.abs(psi) ** 2) @ z)
    return np.stack(out)


def frame_phases(card, cuda, device_model):
    """Phases 6-8: K2 against its plain version, the frame pipeline at
    full width, and its timing. Returns K2's record."""
    import numpy as np
    import torch

    import mlqem_tpu_torch.ops.kernels.evolve as kev
    import mlqem_tpu_torch.ops.kernels.frame_evolve as kfe
    from mlqem_tpu_torch import IsingLabelPipeline, KickedIsingEngine
    from mlqem_tpu_torch.ops.frame_trajectory import (frame_plan,
                                                      frame_theta_eff)

    # -- 6. K2 vs its plain version --------------------------------------------
    rng = np.random.default_rng(6)
    for nq, rows in [(2, 1001), (5, 4099), (10, 3001), (13, 257)]:
        plan, n_rot = kfe.every_kind_plan(rng, nq, 148)
        theta = torch.as_tensor(rng.uniform(-3, 3, size=(rows, n_rot)),
                                dtype=torch.float32, device=cuda)
        got = kfe.evolve_frame_marginals(theta, plan, nq)
        want = kfe.evolve_frame_marginals_reference(theta, plan, nq)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        print(f"K2 vs plain: random plan of every kind, nq={nq} "
              f"rows={rows} ops={len(plan)} max|Δ|={err:.3e}")
        require(err <= K2_TOL, f"K2 disagrees with its plain version "
                f"(nq={nq}, rows={rows}): {err} > {K2_TOL}")

    def pipeline(**kw):
        return IsingLabelPipeline(device_model, nq=NQ, steps=STEPS, dt=DT,
                                  h=1.0, n_traj=N_TRAJ, method="frame",
                                  device=cuda, **kw)

    t0 = time.perf_counter()
    pipe = pipeline(shots=SHOTS)
    tables_s = time.perf_counter() - t0
    plan, rot_meta = frame_plan(pipe.ct_struct)
    counts = {k: sum(op[0] == k for op in plan)
              for k in (kfe.ROT_X, kfe.ROT_Z, kfe.GATE_CX)}
    print(f"bench template plan: {len(plan)} ops = {counts[kfe.ROT_X]} rx + "
          f"{counts[kfe.ROT_Z]} rz + {counts[kfe.GATE_CX]} cx, "
          f"{len(rot_meta)} angles")
    require(len(plan) == 148 and counts == {kfe.ROT_X: 40, kfe.ROT_Z: 36,
                                            kfe.GATE_CX: 72},
            "the bench template's plan is not 40 rx + 36 rz + 72 cx")

    def bench_theta(batch, seed):
        """Sign-folded angles of the pipeline's own draws: [batch·T, R]."""
        gen = torch.Generator(device=cuda)
        gen.manual_seed(seed)
        J = torch.as_tensor(rng.uniform(0.05, 0.6, size=(batch, 1)),
                            dtype=torch.float32, device=cuda)
        ct = pipe.template.bind(J)
        choices = pipe.sample_draws(batch, gen)
        return frame_theta_eff(pipe.ct_struct, ct.params, choices)[0]

    theta = bench_theta(K2_CHECK_ROWS // N_TRAJ, seed=1)
    got = kfe.evolve_frame_marginals(theta, plan, NQ)
    want = kfe.evolve_frame_marginals_reference(theta, plan, NQ)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    print(f"K2 vs plain: bench template plan, rows={theta.shape[0]} "
          f"max|Δ|={err:.3e}")
    require(err <= K2_TOL, f"K2 disagrees on the bench plan: {err}")

    theta = bench_theta(FRAME_BATCH, seed=2)
    got = kfe.evolve_frame_marginals(theta, plan, NQ)
    want = kfe.evolve_frame_marginals_reference(theta, plan, NQ)
    torch.cuda.synchronize()
    big_err = (got - want).abs().max().item()
    del got, want
    require(big_err <= K2_TOL, f"K2 disagrees at bench shape: {big_err}")

    def run_kernel():
        kfe.evolve_frame_marginals(theta, plan, NQ)

    def run_plain():
        kfe.evolve_frame_marginals_reference(theta, plan, NQ)

    k_ms, p_ms, kernel_ms, plain_ms = time_kernel_and_plain(
        run_kernel, run_plain, 1)
    del theta
    torch.cuda.empty_cache()
    print(f"evolve_frame_marginals nq={NQ} ops={len(plan)} rows={FRAME_ROWS}: "
          f"max|Δ|={big_err:.3e}; kernel {k_ms:.3f} ms "
          f"(runs {[round(x, 3) for x in kernel_ms]}), plain PyTorch "
          f"{p_ms:.3f} ms (runs {[round(x, 3) for x in plain_ms]}) [{card}]")

    # -- 7. the frame pipeline at full width -----------------------------------
    J = rng.uniform(0.05, 0.6, size=FRAME_BATCH).astype(np.float32)
    kev.evolve_fused.launches = 0
    kfe.evolve_frame_marginals.launches = 0
    ideal, noisy = pipe.generate(J, seed=0)
    torch.cuda.synchronize()
    launches = kfe.evolve_frame_marginals.launches
    print(f"frame path: 1 batch of {FRAME_BATCH} circuits x {N_TRAJ} "
          f"trajectories, {SHOTS} shots: evolve_frame_marginals launches = "
          f"{launches}, evolve_fused launches = {kev.evolve_fused.launches}")
    require(launches == 1, f"expected 1 K2 launch, got {launches}")
    for name, lab in (("ideal", ideal), ("noisy", noisy)):
        require(lab.shape == (FRAME_BATCH, NQ), f"{name} shape {lab.shape}")
        require(bool(np.isfinite(lab).all()), f"{name} has non-finite values")
        require(bool((np.abs(lab) <= 1.0 + 1e-6).all()),
                f"{name} leaves [-1, 1]")
    exact = exact_ideal_z(J[:4], NQ, STEPS, DT)
    ideal_err = float(np.abs(ideal[:4] - exact).max())
    print(f"frame path ideal labels vs complex128 statevector (4 circuits): "
          f"max|Δ|={ideal_err:.3e}")
    require(ideal_err <= TOL, f"frame path ideal labels wrong: {ideal_err}")
    gap = float(np.abs(noisy - ideal).mean())
    print(f"frame path mean |noisy - ideal| = {gap:.4f}")
    require(gap > 1e-3, "noise had no effect on the frame path")

    labels = {}
    for use_kernel in (True, False):
        p = pipeline(shots=None, use_kernel=use_kernel)
        labels[use_kernel] = p.generate(J, seed=1)
        del p
        torch.cuda.empty_cache()
    path_err = max(float(np.abs(a - b).max())
                   for a, b in zip(labels[True], labels[False]))
    print(f"frame path, shots=None, same draws: kernel path vs plain path: "
          f"max|Δ| = {path_err:.3e} (ideal and noisy)")
    require(path_err <= TOL, f"frame kernel path disagrees: {path_err}")

    kicked = KickedIsingEngine(device_model, nq=NQ, steps=STEPS, dt=DT,
                               n_traj=N_TRAJ, shots=None, device=cuda)
    k_ideal, k_noisy = kicked.generate(J, seed=2)
    del kicked
    torch.cuda.empty_cache()
    d = labels[True][1] - k_noisy          # per circuit, independent draws
    se = d.std(axis=0, ddof=1) / np.sqrt(FRAME_BATCH)
    z = np.abs(d.mean(axis=0)) / se
    print(f"cross-engine, shots=None: batch-mean noisy <Z_q> frame "
          f"{[round(float(x), 4) for x in labels[True][1].mean(axis=0)]} "
          f"vs kicked {[round(float(x), 4) for x in k_noisy.mean(axis=0)]}; "
          f"max |Δ|/se = "
          f"{z.max():.2f} (se {se.max():.1e}); ideal max|Δ| = "
          f"{np.abs(labels[True][0] - k_ideal).max():.2e}")
    require(bool((z <= 5.0).all()), f"frame and kicked engines disagree: "
            f"{z.max():.2f} standard errors")

    # -- 8. timing ---------------------------------------------------------------
    time_batches(pipe.generate, J, rng, card, "frame path ")
    params = torch.as_tensor(pipe.params_from_values(J), device=cuda)
    split = stage_split(lambda gen, mark: pipe.run(params, gen, mark=mark),
                        cuda)
    print(f"frame path stage split (median of 3 batches, synchronized per "
          f"stage) [{card}]:")
    print(f"  (a) noise tables + template (host, once per pipeline): "
          f"{tables_s * 1e3:.1f} ms")
    print(f"  (b) draws + frame walk + theta_eff: {split['frame']:.1f} ms")
    print(f"  (c) K2, {FRAME_ROWS} rows: {split['evolve']:.1f} ms")
    print(f"  (d) frame flip + confusion + shots: {split['readout']:.1f} ms")
    print(f"  (c') ideal arm (statevector, {FRAME_BATCH} circuits, + <Z>): "
          f"{split['ideal']:.1f} ms")
    return {"launches": launches, "max_abs_err": big_err, "ms": k_ms,
            "plain_ms": p_ms}


def main():
    require(os.path.isdir(os.path.join(ROOT, "mlqem_tpu_torch")),
            f"no mlqem_tpu_torch package beside {__file__}")
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    # -- 1. the card ---------------------------------------------------------
    require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    precision = torch.get_float32_matmul_precision()
    print(f"torch.backends.cuda.matmul.allow_tf32 = {tf32}; "
          f"float32_matmul_precision = {precision!r}")
    require(tf32 is False and precision == "highest",
            "float32 matmuls must be IEEE f32 (no TF32)")
    cuda = torch.device("cuda")

    import mlqem_tpu_torch.ops.kernels.evolve as kev
    import mlqem_tpu_torch.ops.kernels.frame_evolve as kfe
    from mlqem_tpu_torch import KickedIsingEngine, configurable_device
    from mlqem_tpu_torch.utils.build import library_path

    # -- 2. build ------------------------------------------------------------
    def timed_build(load):
        t = time.perf_counter()
        load()
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        builds = dict(zip(("evolve", "frame_evolve"),
                          pool.map(timed_build, (kev.load_library,
                                                 kfe.load_library))))
    print(f"build: evolve.cu and frame_evolve.cu built and loaded in "
          f"{time.perf_counter() - t0:.2f} s (in parallel; "
          f"{builds['evolve']:.2f} s and {builds['frame_evolve']:.2f} s)")
    for name in builds:
        log = library_path(name) + ".log"
        if os.path.exists(log):
            with open(log) as f:
                for line in f:
                    if "ptxas info" in line or "bytes stack frame" in line:
                        print(f"  {name}.cu: " + line.strip())

    # -- 3. kernel vs plain version -------------------------------------------
    for nq, rows in [(6, 4099), (8, 4099), (8, 16384), (10, 4099),
                     (10, 16384)]:
        args, nb = kernel_inputs(nq, rows, seed=nq, device=cuda)
        got = kev.evolve_fused(*args, 2.0 * DT, STEPS, nq, nb)
        want = kev.evolve_fused_reference(*args, 2.0 * DT, STEPS, nq, nb)
        torch.cuda.synchronize()
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        print(f"kernel vs plain: nq={nq} rows={rows} steps={STEPS} "
              f"max|Δ|={err:.3e}")
        require(err <= TOL, f"kernel disagrees with its plain version "
                f"(nq={nq}, rows={rows}): {err} > {TOL}")
    args, nb = kernel_inputs(NQ, NOISY_ROWS, seed=0, device=cuda)
    got = kev.evolve_fused(*args, 2.0 * DT, STEPS, NQ, nb)
    want = kev.evolve_fused_reference(*args, 2.0 * DT, STEPS, NQ, nb)
    torch.cuda.synchronize()
    big_err = max((g - w).abs().max().item() for g, w in zip(got, want))
    del got, want
    require(big_err <= TOL, f"kernel disagrees at bench shape: {big_err}")

    def run_kernel():
        kev.evolve_fused(*args, 2.0 * DT, STEPS, NQ, nb)

    def run_plain():
        kev.evolve_fused_reference(*args, 2.0 * DT, STEPS, NQ, nb)

    k_ms, p_ms, kernel_ms, plain_ms = time_kernel_and_plain(
        run_kernel, run_plain, 2)
    del args
    print(f"evolve_fused nq={NQ} steps={STEPS} rows={NOISY_ROWS}: "
          f"max|Δ|={big_err:.3e}; kernel {k_ms:.3f} ms "
          f"(runs {[round(x, 3) for x in kernel_ms]}), plain PyTorch "
          f"{p_ms:.3f} ms (runs {[round(x, 3) for x in plain_ms]}) [{card}]")

    # -- 4. main path ------------------------------------------------------------
    device_model = configurable_device(NQ, seed=0)
    t0 = time.perf_counter()
    eng = KickedIsingEngine(device_model, nq=NQ, steps=STEPS, dt=DT,
                            n_traj=N_TRAJ, shots=SHOTS, device=cuda)
    tables_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    J = rng.uniform(0.05, 0.6, size=BATCH).astype(np.float32)
    kev.evolve_fused.launches = 0
    kfe.evolve_frame_marginals.launches = 0
    ideal, noisy = eng.generate(J, seed=0)
    torch.cuda.synchronize()
    launches = kev.evolve_fused.launches
    print(f"main path: 1 batch of {BATCH} circuits x {N_TRAJ} trajectories, "
          f"{SHOTS} shots: evolve_fused launches = {launches}, "
          f"evolve_frame_marginals launches = "
          f"{kfe.evolve_frame_marginals.launches}")
    require(launches == 2, f"expected 2 kernel launches, got {launches}")
    for name, lab in (("ideal", ideal), ("noisy", noisy)):
        require(lab.shape == (BATCH, NQ), f"{name} shape {lab.shape}")
        require(bool(np.isfinite(lab).all()), f"{name} has non-finite values")
        require(bool((np.abs(lab) <= 1.0 + 1e-6).all()),
                f"{name} leaves [-1, 1]")
    exact = exact_ideal_z(J[:4], NQ, STEPS, DT)
    ideal_err = float(np.abs(ideal[:4] - exact).max())
    print(f"ideal labels vs complex128 statevector (4 circuits): "
          f"max|Δ|={ideal_err:.3e}")
    require(ideal_err <= TOL, f"ideal labels wrong: {ideal_err}")
    gap = float(np.abs(noisy - ideal).mean())
    print(f"mean |noisy - ideal| = {gap:.4f}")
    require(gap > 1e-3, "noise had no effect")

    labels = {}
    for use_kernel in (True, False):
        e = KickedIsingEngine(device_model, nq=NQ, steps=STEPS, dt=DT,
                              n_traj=N_TRAJ, shots=None, device=cuda,
                              use_kernel=use_kernel)
        labels[use_kernel] = e.generate(J, seed=1)
        del e
        torch.cuda.empty_cache()
    path_err = max(float(np.abs(a - b).max())
                   for a, b in zip(labels[True], labels[False]))
    print(f"shots=None, same draws: kernel path vs plain path on the card: "
          f"max|Δ| = {path_err:.3e} (ideal and noisy)")
    require(path_err <= TOL, f"kernel path disagrees: {path_err}")

    # -- 5. timing ------------------------------------------------------------
    time_batches(eng.generate, J, rng, card, "")
    Jt = torch.as_tensor(J, device=cuda)
    split = stage_split(lambda gen, mark: eng.run(Jt, gen, mark=mark), cuda)
    print(f"stage split (median of 3 batches, synchronized per stage) "
          f"[{card}]:")
    print(f"  (a) noise tables (host, once per engine): "
          f"{tables_s * 1e3:.1f} ms")
    print(f"  (b) frame pass (draws + sign propagation): "
          f"{split['frame']:.1f} ms")
    print(f"  (c) evolution, noisy arm (kernel, {NOISY_ROWS} rows): "
          f"{split['evolve']:.1f} ms")
    print(f"  (d) readout + <Z> + flip + shots: {split['readout']:.1f} ms")
    print(f"  (c') ideal arm (kernel, {BATCH} rows, + <Z>): "
          f"{split['ideal']:.1f} ms")

    del eng
    torch.cuda.empty_cache()
    k2 = frame_phases(card, cuda, device_model)

    record = {"kernels": [{
        "name": "evolve_fused", "route": "cuda",
        "source": "mlqem_tpu_torch/csrc/evolve.cu",
        "replaces": "mlqem_tpu/ops/pallas/evolve.py:107",
        "launches": launches, "max_abs_err": big_err,
        "ms": k_ms, "plain_ms": p_ms}, {
        "name": "evolve_frame_marginals", "route": "cuda",
        "source": "mlqem_tpu_torch/csrc/frame_evolve.cu",
        "replaces": "mlqem_tpu/ops/pallas/frame_evolve.py:134",
        "launches": k2["launches"], "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"], "plain_ms": k2["plain_ms"]}]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
