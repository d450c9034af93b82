#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the float32 matmul settings, which must be IEEE f32 (no TF32);
2. build the four kernels at once from ``mlqem_tpu_torch/csrc/``:
   ``evolve.cu`` (K1), ``frame_evolve.cu`` (K2), ``fused_step.cu`` (K3) and
   ``wht.cu`` (K4), one ``nvcc`` each; every instance of K1 and K3 (both
   from ``kicked_regs.cuh``) must show 0 bytes of register spills;
3. hold K1 (``csrc/evolve.cu``) against its plain PyTorch version on the
   card from |0…0⟩ (nq 6, 8, 10) and from random unit-norm states (nq 1,
   4, 5, 6, 10, 11, 13: each side of the kernel's register, shuffle and
   shared-memory splits); 4 steps; ragged row counts; max|Δ| ≤ 1e-5; its
   outputs there equal, bit for bit, to those of K1 before its device code
   moved into ``csrc/kicked_regs.cuh`` (a SHA-256 of them); and time both
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
   plans of every op kind and on plans that move every qubit with every
   kind (nq 1, 2, 4, 5, 6, 10, 11, 13: every register position and the
   lane path of the warp kernel, and the shared-memory kernel; ragged row
   counts), and on the bench template's plan (nq 10, 4 steps: 148 ops,
   which the wrapper merges to 76) at 16,384 and 262,144 rows, and time
   both at the frame pipeline's shape (262,144 rows);
7. run the generic Pauli-frame label pipeline at ``bench.py --method
   frame``'s configuration (``IsingLabelPipeline(method="frame")``: 8192
   circuits × 32 trajectories, nq 10, 4 steps, 10,000 shots) through K2:
   one K2 launch per batch, labels finite, of shape (8192, 10) and in
   [−1, 1], ideal labels matching the numpy statevector, the kernel path
   matching the plain path with ``shots=None``, and the batch-mean noisy
   ⟨Z_q⟩ matching the kicked-Ising engine's within 5 standard errors;
8. time the frame pipeline: pairs/min, the stages, peak device memory;
9. hold K4 (``csrc/wht.cu``) against its plain version (w 1 to 22, ragged
   rows down to 1; max|Δ| ≤ 2e-6·max|want| per plane) and K3
   (``csrc/fused_step.cu``) against its plain version (w 1, 3, 5, 7, 10,
   11, 12, 13, 14: each side of every geometry split; unit-norm states;
   max|Δ| ≤ 1e-5), and time both at the light-cone path's shapes
   (K4 also per pass: its low pass alone, in GB/s, beside the two-pass
   floor);
10. run the light-cone cross-check (``lightcone_crosscheck``: 100 qubits,
    6 steps, w=13, 4096 realizations) against the Pauli-propagation audit
    values that ship in ``docs/demos/results/audit_values_tpu.npz``:
    90 K3 launches, ideal ≤ 1e-3, noisy arms ≤ 0.03;
11. run demo1's configuration (``LightconeIsing``: 100 qubits, 10 steps,
    w=21) through K4: kernel path vs plain path on the same draws
    (≤ 1e-5); the w=21 ideal arm vs the w=13 one over steps 1-6 (≤ 1e-5);
    one call of each arm (nf1: 1024 realizations × 49 shots with the ideal
    arm, 900 K4 launches; nf3: 256 × 196, 200 launches), TREX-corrected
    values inside their readout bounds;
12. time the light-cone path: seconds per circuit for each arm, the stages
    of one window chunk, peak device memory, and the artifact's derived
    engine time.

Every kernel's record holds its bound: the larger of the bytes it must move
over 3.35 TB/s and the f32 operations it must do over 67 TFLOP/s (the
H100 SXM's published peaks).

The line before the last is the card as ``nvidia-smi`` gives it; the one
before that holds the kernels' JSON record. The last line is
``{"ok": true, "device": {...}}``.
"""
import hashlib
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
HBM_BYTES_PER_S = 3.35e12             # H100 SXM, published
F32_FLOPS_PER_S = 67e12               # H100 SXM, f32 outside the tensor cores
# the light-cone path: demo1 (make_demo1_artifact.py) and its cross-check
LC_NQ, LC_STEPS, LC_DT, LC_H = 100, 10, 0.5, 0.66 * 3.141592653589793
LC_QUBITS = (11, 25, 39, 54, 94)
LC_CHUNK = 128
NF1_TRAJ, NF1_SHOTS = 1024, 49        # 50,000 measurements / 1024
NF3_TRAJ, NF3_SHOTS = 256, 196
XCK_TRAJ = 4096                       # the cross-check's realizations
K3_TIME_ROWS = 3 * XCK_TRAJ           # the cross-check's noisy arm
LC_W = 2 * LC_STEPS + 1               # demo1's window, K4's width
K4_TOL = 2e-6                         # relative to max|want| per plane
# phase 3's K1 cases: (nq, rows, random start)
K1_CASES = [(6, 4099, False), (8, 4099, False), (8, 16384, False),
            (10, 4099, False), (10, 16384, False), (1, 1001, True),
            (4, 4099, True), (5, 257, True), (6, 4099, True),
            (10, 4099, True), (11, 129, True), (13, 33, True)]
# SHA-256 of K1's outputs on K1_CASES (re, then im, case by case) from the
# build of csrc/evolve.cu before its device code moved into kicked_regs.cuh
K1_DIGEST = ("7b89b4bdcb5fe09b21c4dedb20e421f4"
             "7ea5b8a4e583659f72fc13803d4dee9f")


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


def kernel_inputs(nq, rows, seed, device, random_start=False):
    """±1 signs and θJ from numpy; |0…0⟩ starts made on the device, or
    unit-norm random starts from numpy."""
    import numpy as np
    import torch

    from mlqem_tpu_torch.ops.kicked_ising import _sign_tables

    rng = np.random.default_rng(seed)
    bit_pm, bond_par = _sign_tables(nq)
    nb = bond_par.shape[1]

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)

    if random_start:
        re, im = rng.normal(size=(2, rows, 2 ** nq))
        norm = np.sqrt((re ** 2 + im ** 2).sum(axis=1, keepdims=True))
        re, im = dev(re / norm), dev(im / norm)
    else:
        re = torch.zeros((rows, 2 ** nq), device=device)
        re[:, 0] = 1.0
        im = torch.zeros_like(re)
    args = [re, im,
            dev(rng.choice([-1.0, 1.0], size=(rows, STEPS * nq))),
            dev(rng.choice([-1.0, 1.0], size=(rows, STEPS * nb))),
            dev(rng.uniform(-1.2, -0.1, size=(rows, 1))),
            dev(bit_pm.T), dev(bond_par.T)]
    return args, nb


def _counted():
    """Every kernel wrapper, by its kernel's name."""
    import mlqem_tpu_torch.ops.kernels.evolve as kev
    import mlqem_tpu_torch.ops.kernels.frame_evolve as kfe
    import mlqem_tpu_torch.ops.kernels.fused_step as kfs
    import mlqem_tpu_torch.ops.kernels.wht as kwht

    return {"evolve_fused": kev.evolve_fused,
            "evolve_frame_marginals": kfe.evolve_frame_marginals,
            "fused_trotter_step": kfs.fused_trotter_step,
            "wht_planes": kwht.wht_planes}


def reset_launches():
    for fn in _counted().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in _counted().items()}


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


def bound(n_bytes, n_flops):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_flops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def step_flops(nq, nb, dim):
    """The least f32 operations of one kicked-Ising Trotter step on one row,
    whatever implements it: two unscaled WHTs (1 add per amplitude per stage
    and plane: 4·nq·dim; the 2^(−nq/2) folds into the phases' cos and sin),
    two complex rotations (6 per amplitude: 12·dim), and the phases' angles:
    with ±1 signs the sign sum takes nq + 1 values (nb + 1 for ZZ) per row
    and step, each a scale and a sincos counted as 2 (3·(nq + nb + 2))."""
    return 4 * nq * dim + 12 * dim + 3 * (nq + nb + 2)


def plan_flops(plan, nq):
    """f32 operations of K2's plan on one row: 6 per amplitude for a
    rotation, 4 for H, 2 for CY and CZ, none for CX and SWAP, then the
    marginals (3 per amplitude for |ψ|², nq for the sums)."""
    import mlqem_tpu_torch.ops.kernels.frame_evolve as kfe

    per_kind = {kfe.GATE_H: 4, kfe.GATE_CY: 2, kfe.GATE_CZ: 2}
    dim = 1 << nq
    return dim * (sum(6 if op[0] in kfe.ROTATION_KINDS
                      else per_kind.get(op[0], 0) for op in plan) + 3 + nq)


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

    import mlqem_tpu_torch.ops.kernels.frame_evolve as kfe
    from mlqem_tpu_torch import IsingLabelPipeline, KickedIsingEngine
    from mlqem_tpu_torch.ops.frame_trajectory import (frame_plan,
                                                      frame_theta_eff)

    # -- 6. K2 vs its plain version --------------------------------------------
    rng = np.random.default_rng(6)
    for nq, rows in [(1, 999), (2, 1001), (4, 4097), (5, 4099), (6, 2053),
                     (10, 3001), (11, 129), (13, 257)]:
        for label, (plan, n_rot) in (
                ("random plan of every kind",
                 kfe.every_kind_plan(rng, nq, 148)),
                ("every qubit moved by every kind",
                 kfe.every_path_plan(rng, nq))):
            theta = torch.as_tensor(rng.uniform(-3, 3, size=(rows, n_rot)),
                                    dtype=torch.float32, device=cuda)
            got = kfe.evolve_frame_marginals(theta, plan, nq)
            want = kfe.evolve_frame_marginals_reference(theta, plan, nq)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            print(f"K2 vs plain: {label}, nq={nq} rows={rows} "
                  f"ops={len(plan)} max|Δ|={err:.3e}")
            require(err <= K2_TOL, f"K2 disagrees with its plain version "
                    f"(nq={nq}, rows={rows}, {label}): {err} > {K2_TOL}")

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
    fused = kfe.fuse_plan(plan)
    print(f"K2 runs it merged: {len(fused)} ops = "
          f"{sum(op[0] == kfe.ROT_X for op in fused)} rx + "
          f"{sum(op[0] == kfe.ROT_ZZ for op in fused)} rzz")

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
    # from the plan the kernel runs (merged): the least work of this run
    k2_bound = bound(4 * theta.numel() + 4 * FRAME_ROWS * NQ + 16 * len(fused),
                     FRAME_ROWS * plan_flops(fused, NQ))
    del theta
    torch.cuda.empty_cache()
    print(f"evolve_frame_marginals nq={NQ} ops={len(plan)} (run as "
          f"{len(fused)}) rows={FRAME_ROWS}: "
          f"max|Δ|={big_err:.3e}; kernel {k_ms:.3f} ms "
          f"(runs {[round(x, 3) for x in kernel_ms]}), plain PyTorch "
          f"{p_ms:.3f} ms (runs {[round(x, 3) for x in plain_ms]}); bound "
          f"{k2_bound[0]:.3f} ms ({k2_bound[1]}) [{card}]")

    # -- 7. the frame pipeline at full width -----------------------------------
    J = rng.uniform(0.05, 0.6, size=FRAME_BATCH).astype(np.float32)
    reset_launches()
    ideal, noisy = pipe.generate(J, seed=0)
    torch.cuda.synchronize()
    launches = kfe.evolve_frame_marginals.launches
    print(f"frame path: 1 batch of {FRAME_BATCH} circuits x {N_TRAJ} "
          f"trajectories, {SHOTS} shots: launches {read_launches()}")
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
            "plain_ms": p_ms, "bound_ms": k2_bound[0],
            "bound_by": k2_bound[1], "library_ms": None}


def lightcone_checks(card, cuda):
    """Phase 9: K4 and K3 against their plain versions, and their times at
    the light-cone path's shapes. Returns (K3, K4) records without their
    launch counts."""
    import torch

    import mlqem_tpu_torch.ops.kernels.fused_step as kfs
    import mlqem_tpu_torch.ops.kernels.wht as kwht
    from mlqem_tpu_torch.ops.kicked_ising import _sign_tables

    gen = torch.Generator(device=cuda)
    gen.manual_seed(9)

    def planes(rows, nq, unit=False):
        re = torch.randn((rows, 2 ** nq), device=cuda, generator=gen)
        im = torch.randn((rows, 2 ** nq), device=cuda, generator=gen)
        if unit:
            norm = (re * re + im * im).sum(dim=1, keepdim=True).sqrt_()
            re.div_(norm)
            im.div_(norm)
        return re, im

    def k4_check(nq, rows):
        re, im = planes(rows, nq)
        want = kwht.wht_planes_reference(re, im, nq)
        kwht.wht_planes(re, im, nq)                    # in place
        torch.cuda.synchronize()
        err = max((g - w).abs().max().item() for g, w in zip((re, im), want))
        rel = max((g - w).abs().max().item() / w.abs().max().item()
                  for g, w in zip((re, im), want))
        print(f"K4 vs plain: w={nq} rows={rows} max|Δ|={err:.3e} "
              f"(relative {rel:.3e})")
        require(rel <= K4_TOL, f"K4 disagrees with its plain version (w={nq},"
                f" rows={rows}): {rel} > {K4_TOL} relative")
        return err

    for nq, rows in [(1, 5), (4, 7), (5, 3), (6, 33), (8, 1001), (12, 3),
                     (13, 33), (14, 7), (17, 3), (18, 2), (LC_W, 1), (22, 1),
                     (22, 3)]:
        k4_check(nq, rows)
    k4_err = k4_check(LC_W, LC_CHUNK + 1)
    torch.cuda.empty_cache()

    def k3_args(nq, rows):
        bit_pm, bond_par = _sign_tables(nq)
        nb = bond_par.shape[1]
        re, im = planes(rows, nq, unit=True)

        def signs(k):
            return (2.0 * torch.randint(0, 2, (rows, k), device=cuda,
                                        generator=gen) - 1.0)

        theta = torch.rand((rows, 1), device=cuda, generator=gen) * -1.1 - 0.1
        return [re, im, signs(nq), signs(nb), theta,
                torch.as_tensor(bit_pm, device=cuda),
                torch.as_tensor(bond_par, device=cuda)]

    def k3_check(nq, rows):
        args = k3_args(nq, rows)
        got = kfs.fused_trotter_step(*args, 2.0 * LC_H * LC_DT)
        want = kfs.fused_trotter_step_reference(*args, 2.0 * LC_H * LC_DT)
        torch.cuda.synchronize()
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        print(f"K3 vs plain: w={nq} rows={rows} max|Δ|={err:.3e}")
        require(err <= TOL, f"K3 disagrees with its plain version (w={nq}, "
                f"rows={rows}): {err} > {TOL}")
        return err, args

    for nq, rows in [(1, 999), (3, 1001), (5, 2049), (7, 4099), (10, 3001),
                     (11, 129), (12, 65), (13, 257), (kfs.MAX_NQ, 33)]:
        k3_check(nq, rows)
    k3_err, args = k3_check(13, K3_TIME_ROWS)
    theta_h = 2.0 * LC_H * LC_DT
    k3_ms, k3_plain, k3_runs, k3_plain_runs = time_kernel_and_plain(
        lambda: kfs.fused_trotter_step(*args, theta_h),
        lambda: kfs.fused_trotter_step_reference(*args, theta_h), 2)
    nb = args[3].shape[1]
    k3_bound = bound(4 * sum(a.numel() for a in args) + 8 * args[0].numel(),
                     K3_TIME_ROWS * step_flops(13, nb, 2 ** 13))
    del args
    print(f"fused_trotter_step w=13 rows={K3_TIME_ROWS}: max|Δ|={k3_err:.3e};"
          f" kernel {k3_ms:.3f} ms (runs {[round(x, 3) for x in k3_runs]}), "
          f"plain PyTorch {k3_plain:.3f} ms (runs "
          f"{[round(x, 3) for x in k3_plain_runs]}); bound {k3_bound[0]:.3f} "
          f"ms ({k3_bound[1]}) [{card}]")

    k4 = {}
    for rows in (LC_CHUNK, 1):
        re, im = planes(rows, LC_W)
        k_ms, p_ms, k_runs, p_runs = time_kernel_and_plain(
            lambda: kwht.wht_planes(re, im, LC_W),
            lambda: kwht.wht_planes_reference(re, im, LC_W), 1)
        k_bound = bound(2 * 8 * re.numel(), 2 * 2 * LC_W * re.numel())
        if rows == LC_CHUNK:
            # the low pass alone: the same bytes as rows of 2^13
            low_re = re.view(-1, 2 ** 13)
            low_im = im.view(-1, 2 ** 13)
            low_ms = min(time_ms(lambda: kwht.wht_planes(low_re, low_im, 13),
                                 5) for _ in range(2))
            pass_gb = 2 * 8 * re.numel() / 1e9     # read + write, 2 planes
            floor_ms = 2 * pass_gb * 1e9 / HBM_BYTES_PER_S * 1e3
            print(f"wht_planes w={LC_W} rows={rows} per pass: low pass (bits "
                  f"0-12) {low_ms:.3f} ms = {pass_gb / low_ms * 1e3:.0f} GB/s, "
                  f"high pass (bits 13-{LC_W - 1}, the rest of the call) "
                  f"{k_ms - low_ms:.3f} ms = "
                  f"{pass_gb / (k_ms - low_ms) * 1e3:.0f} GB/s; two-pass floor {floor_ms:.3f} ms ({pass_gb:.2f} GB "
                  f"a pass over {HBM_BYTES_PER_S / 1e12} TB/s) [{card}]")
        del re, im
        torch.cuda.empty_cache()
        gbs = 16 * rows * 2 ** LC_W / (k_ms * 1e-3) / 1e9
        print(f"wht_planes w={LC_W} rows={rows} x 2 planes: kernel {k_ms:.3f} ms "
              f"(runs {[round(x, 3) for x in k_runs]}; {gbs:.0f} GB/s of "
              f"input+output), plain PyTorch {p_ms:.3f} ms (runs "
              f"{[round(x, 3) for x in p_runs]}); bound {k_bound[0]:.3f} ms "
              f"({k_bound[1]}) [{card}]")
        k4[rows] = (k_ms, p_ms, k_bound)
    k_ms, p_ms, k_bound = k4[LC_CHUNK]
    return ({"max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain,
             "bound_ms": k3_bound[0], "bound_by": k3_bound[1],
             "library_ms": None},
            {"max_abs_err": k4_err, "ms": k_ms, "plain_ms": p_ms,
             "bound_ms": k_bound[0], "bound_by": k_bound[1],
             "library_ms": None})


def lightcone_phases(card, cuda):
    """Phases 9-12: K3 and K4 against their plain versions, the cross-check
    on the audit values, demo1's configuration at w=21, and its timing.
    Returns the (K3, K4) records."""
    import numpy as np
    import torch

    from mlqem_tpu_torch import LightconeIsing, NoiseModel, configurable_device
    from mlqem_tpu_torch.ops.lightcone import readout_affine
    from mlqem_tpu_torch.workflows.demos import (DEMO1_CALIBRATED_SCALE,
                                                 lightcone_crosscheck)

    # -- 9. K4 and K3 vs their plain versions -------------------------------------
    k3, k4 = lightcone_checks(card, cuda)

    # -- 10. the cross-check against the audit values ------------------------
    audit = np.load(os.path.join(ROOT, "docs", "demos", "results",
                                 "audit_values_tpu.npz"))
    require(int(audit["device_seed"]) == 1, "audit device_seed is not 1")
    xck_j = tuple(float(x) for x in audit["J_values"])
    xck_q = tuple(int(q) for q in audit["qubits"])
    xck_h = float(audit["h"])
    dev = configurable_device(LC_NQ, seed=1)
    reset_launches()
    t0 = time.perf_counter()
    xck = lightcone_crosscheck(
        dev, nq=LC_NQ, steps=6, dt=float(audit["dt"]), h=xck_h,
        J_values=xck_j, qubits=xck_q, n_traj=XCK_TRAJ,
        reference={k: audit[k] for k in ("ideal", "nf1", "nf3")}, seed=1,
        device=cuda)
    torch.cuda.synchronize()
    counts = read_launches()
    print(f"cross-check (100q, 6 steps, w=13, {XCK_TRAJ} realizations) vs the "
          f"audit values: ideal max|Δ|={xck['ideal_max_diff']:.3e} (tol "
          f"{xck['ideal_tol']}), noisy {xck['noisy_max_diff']} (tol "
          f"{xck['noisy_tol']}), passed={xck['passed']}; launches {counts}; "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    require(xck["passed"], "the light-cone cross-check failed")
    require(counts["fused_trotter_step"] == 90 and counts["wht_planes"] == 0,
            f"expected 90 K3 and 0 K4 launches, got {counts}")
    k3["launches"] = counts["fused_trotter_step"]

    # -- 11. demo1's configuration at w=21 -----------------------------------
    nm = NoiseModel.from_device(dev, scale=DEMO1_CALIBRATED_SCALE)
    J50 = np.random.RandomState(42).uniform(0.0, 0.66 * np.pi, 50
                                            ).astype(np.float32)

    def engine(n_traj, shots, **kw):
        return LightconeIsing(dev, nq=LC_NQ, steps=LC_STEPS, device=cuda,
                              dt=LC_DT, h=LC_H, n_traj=n_traj, shots=shots,
                              noise_model=nm, **kw)

    paths = []
    for use_kernel in (None, False):       # None: the kernels, on the card
        eng = engine(LC_CHUNK, None, use_kernel=use_kernel)
        paths.append(eng.generate_stepwise(J50[1:2], qubits=(54,), seed=0))
        del eng
        torch.cuda.empty_cache()
    path_err = max(float(np.abs(a - b).max()) for a, b in zip(*paths))
    print(f"demo1 window q=54 (w={LC_W}), {LC_CHUNK} realizations, shots=None, "
          f"same draws: kernel path vs plain path max|Δ|={path_err:.3e}")
    require(path_err <= TOL, f"light-cone kernel path disagrees: {path_err}")

    ideal_w = {}
    for steps in (LC_STEPS, 6):
        eng = LightconeIsing(dev, nq=LC_NQ, steps=steps, device=cuda,
                             dt=LC_DT, h=xck_h, n_traj=1, shots=None,
                             noise=False, readout=False)
        ideal_w[2 * steps + 1] = eng.ideal_stepwise(np.asarray(xck_j), xck_q)
        del eng
    cone_err = float(np.abs(ideal_w[LC_W][:, :6] - ideal_w[13]).max())
    audit_err = float(np.abs(ideal_w[LC_W][:, :6]
                             - audit["ideal"][:, :6]).max())
    print(f"cone exactness: ideal arm w={LC_W} (K4) vs w=13 (K3) over steps 1-6 "
          f"max|Δ|={cone_err:.3e}; vs the audit ideal {audit_err:.3e}")
    require(cone_err <= TOL, f"w={LC_W} and w=13 ideal arms differ: "
            f"{cone_err}")
    require(audit_err <= 1e-3, f"w={LC_W} ideal arm vs audit: {audit_err}")
    torch.cuda.empty_cache()

    eng_n = engine(NF1_TRAJ, NF1_SHOTS, t_chunk=LC_CHUNK)
    eng_a = engine(NF3_TRAJ, NF3_SHOTS, t_chunk=LC_CHUNK)

    def nf1(J, seed=0):
        return eng_n.generate_stepwise(J, 1.0, LC_QUBITS, seed=seed,
                                       want_ideal=True, readout_correct=True)

    def nf3(J, seed=1):
        return eng_a.generate_stepwise(J, 3.0, LC_QUBITS, seed=seed,
                                       want_ideal=False, readout_correct=True)

    reset_launches()
    noisy, ideal = nf1(J50[1:2])
    torch.cuda.synchronize()
    c1 = read_launches()
    reset_launches()
    amp, _ = nf3(J50[1:2])
    torch.cuda.synchronize()
    c3 = read_launches()
    print(f"demo1 circuit J={J50[1]:.4f}: nf1 arm launches {c1}; nf3 arm "
          f"launches {c3}")
    require(c1["wht_planes"] == 2 * LC_STEPS * 5 * (NF1_TRAJ // LC_CHUNK + 1)
            and c1["fused_trotter_step"] == 0, f"nf1 launches {c1}")
    require(c3["wht_planes"] == 2 * LC_STEPS * 5 * (NF3_TRAJ // LC_CHUNK)
            and c3["fused_trotter_step"] == 0, f"nf3 launches {c3}")
    k4["launches"] = c1["wht_planes"] + c3["wht_planes"]
    for name, lab in (("ideal", ideal), ("nf1", noisy), ("nf3", amp)):
        require(lab.shape == (1, LC_STEPS, 5), f"{name} shape {lab.shape}")
        require(bool(np.isfinite(lab).all()), f"{name} has non-finite values")
    require(bool((np.abs(ideal) <= 1.0 + 1e-6).all()), "ideal leaves [-1, 1]")
    for qi, q in enumerate(LC_QUBITS):
        a, b = readout_affine(eng_n.window_tables(q)["confusion"])
        lo, hi = sorted(((-1.0 - b) / a, (1.0 - b) / a))
        for name, lab in (("nf1", noisy), ("nf3", amp)):
            v = lab[:, :, qi]
            require(bool(((v >= lo - 1e-6) & (v <= hi + 1e-6)).all()),
                    f"{name} q={q} leaves its TREX bounds [{lo}, {hi}]")
    gap = float(np.abs(noisy - ideal).mean())
    print(f"demo1 circuit: ideal step 10 {np.round(ideal[0, -1], 4).tolist()}"
          f", nf1 {np.round(noisy[0, -1], 4).tolist()}, nf3 "
          f"{np.round(amp[0, -1], 4).tolist()}; mean |nf1 - ideal| = "
          f"{gap:.4f}")
    require(gap > 1e-3, "noise had no effect on the light-cone path")

    # -- 12. timing ----------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    secs = {}
    for name, arm in (("nf1 (+ ideal)", nf1), ("nf3", nf3)):
        runs = []
        for k in range(2, 5):                  # after the warm-up above
            t0 = time.perf_counter()
            arm(J50[k:k + 1])                  # ends in a host copy
            runs.append(time.perf_counter() - t0)
        secs[name] = statistics.median(runs)
        print(f"light-cone {name} arm: {secs[name]:.3f} s per circuit "
              f"(median of {len(runs)}; runs "
              f"{[round(x, 3) for x in runs]}) [{card}]")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"light-cone peak device memory: {peak_gib:.2f} GiB "
          f"(torch.cuda.max_memory_allocated) [{card}]")

    t0 = time.perf_counter()
    for q in LC_QUBITS:
        tw = eng_n.window_tables(q)
    tables_ms = (time.perf_counter() - t0) * 1e3
    tw = eng_n.window_tables(54)
    probs = torch.as_tensor(tw["probs"], device=cuda)
    a, b = readout_affine(tw["confusion"])
    theta_j = torch.as_tensor(-2.0 * LC_DT * J50[1:2], device=cuda)
    split = {}
    for seed in range(3):
        gen = torch.Generator(device=cuda)
        gen.manual_seed(seed)
        sums = {}
        torch.cuda.synchronize()
        last = [time.perf_counter()]

        def mark(stage):
            torch.cuda.synchronize()
            now = time.perf_counter()
            sums[stage] = sums.get(stage, 0.0) + (now - last[0]) * 1e3
            last[0] = now

        eng_n.run_noisy(tw, theta_j, probs, a, b, gen, mark)
        for stage, ms in sums.items():
            split.setdefault(stage, []).append(ms)
    split = {k: statistics.median(v) for k, v in split.items()}
    print(f"light-cone stage split, one window chunk ({LC_CHUNK} "
          f"realizations x 2^{LC_W}, {LC_STEPS} steps; median of 3, "
          f"synchronized per stage) [{card}]:")
    print(f"  (once per window and call, host) window tables: "
          f"{tables_ms / len(LC_QUBITS):.1f} ms")
    print(f"  frame pass (draws + frame walk): {split['frame']:.1f} ms")
    print(f"  K4 WHTs ({2 * LC_STEPS} calls): {split['wht']:.1f} ms")
    print(f"  RX + ZZ phases (sign matmuls, cos/sin, rotations): "
          f"{split['phase']:.1f} ms")
    print(f"  <Z_obs> per step: {split['z']:.1f} ms")
    print(f"  flip + readout + shots + mean: {split['shots']:.1f} ms")
    per_circuit = secs["nf1 (+ ideal)"] + secs["nf3"]
    print(f"derived, not measured end to end: the demo1 artifact's engine "
          f"arms (50 circuits + the J00 row re-evolved) = 51 x "
          f"{per_circuit:.3f} s = {51 * per_circuit:.1f} s [{card}]")
    del eng_n, eng_a
    torch.cuda.empty_cache()
    return k3, k4


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
    import mlqem_tpu_torch.ops.kernels.fused_step as kfs
    import mlqem_tpu_torch.ops.kernels.wht as kwht
    from mlqem_tpu_torch import KickedIsingEngine, configurable_device
    from mlqem_tpu_torch.utils.build import library_path

    # -- 2. build ------------------------------------------------------------
    def timed_build(load):
        t = time.perf_counter()
        load()
        return time.perf_counter() - t

    t0 = time.perf_counter()
    loaders = {"evolve": kev.load_library, "frame_evolve": kfe.load_library,
               "fused_step": kfs.load_library, "wht": kwht.load_library}
    with ThreadPoolExecutor(len(loaders)) as pool:
        builds = dict(zip(loaders, pool.map(timed_build, loaders.values())))
    print(f"build: {', '.join(n + '.cu' for n in builds)} built and loaded "
          f"in {time.perf_counter() - t0:.2f} s (in parallel; "
          + ", ".join(f"{n} {t:.2f} s" for n, t in builds.items()) + ")")
    for name in builds:
        log = library_path(name) + ".log"
        spills = []
        if os.path.exists(log):
            with open(log) as f:
                for line in f:
                    if "ptxas info" in line or "bytes stack frame" in line:
                        print(f"  {name}.cu: " + line.strip())
                    if "spill stores" in line:
                        spills.append("0 bytes spill stores, 0 bytes spill "
                                      "loads" in line)
        if name in ("evolve", "fused_step"):
            require(spills and all(spills), f"{name}.cu spills registers "
                    f"({spills.count(False)} of {len(spills)} functions)")
        print(f"  {name}.cu: {spills.count(True)} of {len(spills)} functions "
              f"without register spills")

    # -- 3. kernel vs plain version -------------------------------------------
    digest = hashlib.sha256()
    for nq, rows, rand in K1_CASES:
        args, nb = kernel_inputs(nq, rows, seed=nq, device=cuda,
                                 random_start=rand)
        got = kev.evolve_fused(*args, 2.0 * DT, STEPS, nq, nb)
        want = kev.evolve_fused_reference(*args, 2.0 * DT, STEPS, nq, nb)
        torch.cuda.synchronize()
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        for g in got:
            digest.update(g.cpu().numpy().tobytes())
        print(f"kernel vs plain: nq={nq} rows={rows} steps={STEPS} start="
              f"{'random' if rand else '|0>'} max|Δ|={err:.3e}")
        require(err <= TOL, f"kernel disagrees with its plain version "
                f"(nq={nq}, rows={rows}): {err} > {TOL}")
    print(f"K1 outputs on these cases: SHA-256 {digest.hexdigest()} "
          f"(before the header move: {K1_DIGEST})")
    require(digest.hexdigest() == K1_DIGEST,
            "K1's outputs changed from those before the header move")
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
    k1_bound = bound(4 * sum(a.numel() for a in args) + 8 * args[0].numel(),
                     NOISY_ROWS * STEPS * step_flops(NQ, nb, 2 ** NQ))
    del args
    print(f"evolve_fused nq={NQ} steps={STEPS} rows={NOISY_ROWS}: "
          f"max|Δ|={big_err:.3e}; kernel {k_ms:.3f} ms "
          f"(runs {[round(x, 3) for x in kernel_ms]}), plain PyTorch "
          f"{p_ms:.3f} ms (runs {[round(x, 3) for x in plain_ms]}); bound "
          f"{k1_bound[0]:.3f} ms ({k1_bound[1]}) [{card}]")

    # -- 4. main path ------------------------------------------------------------
    device_model = configurable_device(NQ, seed=0)
    t0 = time.perf_counter()
    eng = KickedIsingEngine(device_model, nq=NQ, steps=STEPS, dt=DT,
                            n_traj=N_TRAJ, shots=SHOTS, device=cuda)
    tables_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    J = rng.uniform(0.05, 0.6, size=BATCH).astype(np.float32)
    reset_launches()
    ideal, noisy = eng.generate(J, seed=0)
    torch.cuda.synchronize()
    launches = kev.evolve_fused.launches
    print(f"main path: 1 batch of {BATCH} circuits x {N_TRAJ} trajectories, "
          f"{SHOTS} shots: launches {read_launches()}")
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
    torch.cuda.empty_cache()
    k3, k4 = lightcone_phases(card, cuda)

    k1 = {"launches": launches, "max_abs_err": big_err, "ms": k_ms,
          "plain_ms": p_ms, "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
          "library_ms": None}
    kernels = [
        ("evolve_fused", "evolve.cu", "evolve.py:107", k1),
        ("evolve_frame_marginals", "frame_evolve.cu", "frame_evolve.py:134",
         k2),
        ("fused_trotter_step", "fused_step.cu", "fused_step.py:110", k3),
        ("wht_planes", "wht.cu", "wht.py:55", k4)]
    record = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"mlqem_tpu_torch/csrc/{src}",
         "replaces": f"mlqem_tpu/ops/pallas/{tpu}", **rec}
        for name, src, tpu, rec in kernels]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
