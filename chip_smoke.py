#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --k2-tiers PARENT_FRAME_EVOLVE_CU

The second form runs phases 1-2 and then only K2's tier timings of phase
22, each in turns with the build of PARENT_FRAME_EVOLVE_CU (a copy of
``csrc/frame_evolve.cu`` from before its tiers above 10 qubits were
redesigned, whose C entry point takes no pass records).

Phases, each of which exits non-zero on failure:
1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the float32 matmul settings, which must be IEEE f32 (no TF32);
2. build the four kernels at once from ``mlqem_tpu_torch/csrc/``:
   ``evolve.cu`` (K1), ``frame_evolve.cu`` (K2), ``fused_step.cu`` (K3) and
   ``wht.cu`` (K4), one ``nvcc`` each; every instance of K1, K2 and K3
   must show 0 bytes of register spills;
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
   kind (nq 1, 2, 4, 5, 6, 10: every register position and the lane path
   of the warp tier; nq 11-14, the chip tier; nq 15, 16, 18, 20, the pass
   tier; ragged row counts; above 10 qubits also the Ising template's
   plan), and on the bench template's plan (nq 10, 4 steps: 148 ops,
   which the wrapper merges to 76) at 16,384 and 262,144 rows: its
   outputs at nq 10 equal, bit for bit, to those of the build before the
   tiers above 10 qubits were redesigned (a SHA-256 of them); and time
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
    engine time;
13. run the exact density-matrix path (``IsingLabelPipeline(method=
    "density_matrix")``, 512 circuits) against an independent complex128
    numpy density matrix, its engines against each other, and time it;
14. run the Estimator API, ``CountsBackend`` and ``zne(NoisyEstimator)`` on
    the 10-qubit circuit against numpy;
15. the learning stack's flat-feature path: ``tomography_sweep`` (more data,
    lower mitigated RMSE), ``RandomForestRegressor(100).predict`` on the
    card against the same forest on the CPU (≤ 1e-6),
    ``learning(NoisyEstimator)`` with the forest against its predict on
    ``encode_data`` (≤ 1e-6), ``train_mlp(MLP1(64, 4))`` on 58-dim
    features (finite, falling loss); the forest's fit and predict times;
16. the GNN path: ``generate_exp_val_dataset`` (fake_lima, 4 qubits, 200
    entries), the paper's GNN (``ExpValCircuitGraphModel3``, hidden 15)
    on the card against the CPU (forward ≤ 1e-5; one Adam step, dropout
    off, ≤ 1e-5 but for the null-gradient biases), ``train_gnn_mitigation``
    at its defaults (finite history, validation loss falls),
    ``ngem(NoisyEstimator)`` against ``predict`` (≤ 1e-5); the dataset
    time, train-step ms and its device busy share (``torch.profiler``),
    s per epoch, predict graphs/s, RMSEs, peak memory.
    No kernel runs in phases 13-16;
17. ``KickedIsingEngine`` above K1's width: at nq 14 through K3 and at nq
    20 through K4 (a step at a time), each against the plain path on the
    same draws (``shots=None``, ≤ 1e-5) with its launch counts; then
    ``zne_sweep_ising`` at its defaults (BASELINE config 4: nq 20, 4
    steps, 16 J values, 64 trajectories, 10,000 shots, noise factors
    (1, 3)) through K4, its ideal labels for 4 J values against a
    complex128 statevector (≤ 1e-5); seconds, peak memory, launches, RMSEs;
18. the datasets and the model zoo (BASELINE configs 1-3): every dataset
    family's labels on the card against the CPU (``shots=None``, ≤ 1e-5);
    ``demo2_ising_4q`` at its defaults; ``random_circuit_dataset`` on
    ``configurable_device(10, seed=0)`` with ``model_comparison`` (OLS, RF;
    MLP1 and the GNN at cut epoch counts); ``train_gnn_mbl`` at its
    defaults but a cut epoch count; dataset seconds, s per epoch, RMSEs.
    No kernel runs in phase 18;
19. ``demo1_zne_mimic_100q`` (BASELINE config 5) at 100 qubits, 10 steps,
    w=21 through K4, with cut circuit and realization counts (printed): its
    ideal rows against ``LightconeIsing.ideal_stepwise`` (≤ 1e-6), the J00
    row against cos(s·π/2) (≤ 1e-5); seconds, peak memory, RMSEs;
20. the sparse Pauli-propagation engine (``PauliPropagatorIsing``, plain
    torch, no kernel): (a) card vs CPU at nq 40 (two words a term), 3
    steps, ideal/nf1/nf3, at a K that keeps every term (≤ 1e-6, nothing
    discarded on either side) and at one that cuts (≤ 1e-5); (b) the
    shipped K=131072 audit recomputed at its configuration (100 qubits, 10
    steps, h = 0.5π): steps 1-6 within 1e-3 of ``audit_values_tpu.npz``,
    steps 7-10 printed; ``truncation_convergence`` at K (16384, 65536,
    131072), its per-step drifts beside ``truncation_audit_tpu.json``'s, the
    top-pair drift ≤ 1e-3 through step 5; (c) ``lightcone_crosscheck(
    reference=None, max_terms=131072)`` at phase 10's configuration: passes,
    90 K3 launches, beside phase 10's differences; (d)
    ``demo1_zne_mimic_100q(engine="pauli_prop")`` at demo1's physics with
    phase 19's cut circuit counts: the J00 row against cos(s·π/2) (≤ 1e-5),
    RMSEs;
21. the stabilizer tableau and the workflows above it: (a)
    ``scalability_sweep`` at its defaults (5-400 qubits, depths 1, 4, 7, 20
    circuits each), labels on the card equal to those on the CPU,
    circuits/s per width; (b) ``generate_rb_circuit`` at 2 and 3 qubits
    composes to the identity (the statevector, ≤ 1e-5); (c)
    ``single_ising_parity("incoherent", protocol="faithful")`` at full
    dataset sizes with cut MLP/GNN epochs and no forest arm (printed): the
    noisy RMSE within 10% of the published 0.172, every arm beside the
    published one. Each phase 20-21 step prints its wall time and peak
    device memory;
22. ``IsingLabelPipeline`` at nq 14 (2 steps): ``"frame"`` and
    ``"trajectory"`` (K2's chip tier, one launch) and
    ``"trajectory_gather"`` (the gather engine, no launch) card vs CPU on
    shared draws (``shots=None``, ≤ 1e-5), the engine each took
    (``noisy_engine``), a timed batch; K2 against its plain version at the
    timed batch's shape, with both times and the bound; at nq 13
    ``"frame"`` still launches K2 once; K2 on the Ising template at nq 11,
    12, 13, 14 (chip tier), 16 and 20 (pass tier): max|Δ| ≤ 2e-5, its
    time, passes and relayouts beside the plain version's and the bound;
23. ``vqe_dataset`` at the reference's size (fake_lima, 5 Paulis × 5000
    ansatz draws, 10,000 shots): seconds split into the Estimators and the
    host transpile + encode, peak memory; a 200-circuit slice card vs CPU
    (``shots=None``, ≤ 1e-5);
24. ``h2_dissociation_curve``'s steps at its defaults (``vqe_dataset`` at
    80 draws a Pauli, ``train_vqe_processor`` with RF(300),
    ``vqe_mitigation_study`` with COBYLA 60, 10,000 shots) on
    ``PUBLISHED_H2``'s four bond lengths: each arm beside the published
    one, the mean mitigated error below the mean noisy error, the
    dataset, forest, per-bond and per-arm seconds, the device
    busy share of one mitigated energy evaluation; one bond at
    ``shots=None``, COBYLA 20, card vs CPU (every arm ≤ 1e-5);
25. ``entry()``'s forward card vs CPU (≤ 1e-5) and its ms, the native
    encoder library built with the host compiler against its numpy
    versions, a QASM round trip. No kernel runs in phases 23-25;
26. the mesh on the card: a one-rank NCCL mesh (``make_mesh``), the kicked
    engine at the bench configuration and the frame pipeline at 8192
    circuits through ``generate(mesh=)``: equal to the unsharded call on
    the same seed (≤ 1e-6 at ``shots=None``; the shots too), the same
    launches (2 of K1, 1 of K2) with the counts set to 0 just before the
    sharded call, and each batch's time beside the unsharded one;
27. the amplitude-sharded statevector on the one-rank mesh at
    ``SV_NQ`` qubits (a depth-2 Ising circuit) against ``statevector``
    (state and ⟨Z_q⟩ ≤ 1e-5), with times and peak memory; on 8 gloo CPU
    ranks of this machine: ``dryrun_multichip(8, device="cpu")`` and the
    sp = 2, 4, 8 states against the one-rank state (≤ 1e-5); then
    ``dryrun_multichip(1)`` on the card. One card, so no multi-GPU time;
28. the artifacts and runners: demo2's artifact at its full protocol
    (5 seeds, 120 training circuits, 10,000 shots) through the full gate
    (``check_demo2(full=True)``), demo1's and the parity table's writers
    at ``--fast`` (the parity table cut to ``PARITY_FAST_SEEDS`` ×
    ``PARITY_FAST_SETTINGS``) through ``full=False``, their figures, and
    every tutorial and demo runner at ``fast=True`` with its headline
    and wall time.

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
# SHA-256 of K2's nq-10 output on the bench plan (theta from
# default_rng(10), uniform(-3, 3), K2_CHECK_ROWS rows) from the build
# before the tiers above 10 qubits were redesigned: the warp tier unchanged
K2_DIGEST = ("2b0e33b318b9a27ca8f24c9bcb18fe75"
             "519d3e52c3b0c2fc03f1c6bb73b88ea8")
# phase 22's K2 timings at each tier's widths (the Ising template, 2 steps):
# 2^27 amplitudes a call on chip, 2^28 and 2^27 in the pass tier
K2_TIER_ROWS = ((11, 65536), (12, 32768), (13, 16384), (14, 8192),
                (16, 2048), (20, 128))
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
# the exact path: bench.py --method density_matrix, and the batch-cap probe
DM_BATCH, DM_CAP_BATCH = 512, 2048
DM_CHECK, DM_NP_CHECK = 8, 2          # engine cross-checks; numpy circuits
EST_TRAJ = 4096                       # TrajectoryEstimator's realizations
# phases 17-19: the workflows of BASELINE.json's five configurations
ZNE_NQ, ZNE_J, ZNE_TRAJ = 20, 16, 64   # zne_sweep_ising's defaults
WIDE_J, WIDE_TRAJ = 4, 16              # phase 17's card-vs-plain batches
RC_CIRCUITS, RC_DEPTH = 200, 5         # random_circuit_dataset, 10 qubits
MC_MLP_EPOCHS, MC_GNN_EPOCHS = 50, 40  # model_comparison's 150 / 400, cut
MBL_EPOCHS = 30                        # train_gnn_mbl's 200, cut
D1_STEPS = 10                          # demo1's depth: w = 21, K4
D1_CIRCUITS, D1_TRAIN = 4, 2           # demo1's 50 / 10 a step, cut
D1_TWIRLS, D1_TWIRLS_AMP = 128, 32     # realizations: the artifact's 1024 /
D1_SHOTS = round(50000 / D1_TWIRLS)    # 256 cut; its 50,000 shots split
# phases 20-21: the Pauli-propagation and stabilizer engines
PP_NQ, PP_STEPS = 40, 3                # phase 20a: two 32-bit words a term
PP_QUBITS = (0, 31, 32, 39)            # each side of the word boundary
PP_K_EXACT, PP_K_TRUNC = 4096, 128     # 368 live terms at most: 0 / some cut
PP_TRUNC_TOL = 1e-5                    # card vs CPU where terms are cut
AUDIT_KS = (16384, 65536, 131072)      # truncation_audit_tpu.json's K
AUDIT_TOL = 1e-3                       # the cross-check's ideal_tol
AUDIT_GATED = 6                        # steps held to the shipped values
DRIFT_GATED = 5                        # steps whose top-pair drift is held
PARITY_MLP_EPOCHS, PARITY_GNN_EPOCHS = 20, 10   # of 200 / 400, cut
# phases 22-25: the frame pipeline above K2's shared-memory width, the VQE
# application
WIDE_FRAME_NQ = 14                     # K2's shared-memory width + 1
WIDE_FRAME_B, WIDE_FRAME_T = 8, 8      # card vs CPU on shared draws
WIDE_FRAME_TIME_B = 256                # the timed batch (x 32 trajectories)
VQE_SAMPLES = 5000                     # vqe_data_gen_parallel.py's per Pauli
VQE_SHOTS = 10000
VQE_CHECK_SAMPLES = 40                 # 200 circuits card vs CPU
H2_BONDS = [0, 1, 2, 3]                # PUBLISHED_H2's bond lengths
H2_CHECK_BOND, H2_CHECK_MAXITER = 3, 20
PARITY_ARMS = ("ols", "mlp", "gnn", "zne")      # the forest arm is cut
# phases 26-28: the mesh, the sharded statevector, the artifacts
SV_NQ = 28                             # phase 27's width on one card
SV_CPU_NQ = 12                         # the 8 CPU ranks' width
PARITY_FAST_SEEDS = ("0",)             # of --fast's 3 seeds, cut
PARITY_FAST_SETTINGS = ("incoherent",)  # of 3 settings, cut
RUNNERS = ("t01_ngem", "t02_data_generation",
           "t03_experiments_on_lima_backend", "t04_ngem_vqe",
           "t05_stability_over_time", "t06_scalability",
           "t07_generalization", "a1_simulation_engines", "a2_scale_100q",
           "a3_multichip_sharding", "z01_mlp_debug",
           "demo1_rf_mimic_zne_100q", "demo2_ising_4q")
# phase 3's K1 cases: (nq, rows, random start)
K1_CASES = [(6, 4099, False), (8, 4099, False), (8, 16384, False),
            (10, 4099, False), (10, 16384, False), (1, 1001, True),
            (4, 4099, True), (5, 257, True), (6, 4099, True),
            (10, 4099, True), (11, 129, True), (13, 33, True)]
# SHA-256 of K1's outputs on K1_CASES (re, then im, case by case) from the
# build of csrc/evolve.cu before its device code moved into kicked_regs.cuh
K1_DIGEST = ("7b89b4bdcb5fe09b21c4dedb20e421f4"
             "7ea5b8a4e583659f72fc13803d4dee9f")


# results a later phase prints beside its own (phase 10's cross-check)
RESULTS = {}


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


def ising_plan(nq, steps=2):
    """(plan, angle slots) of the Ising template at nq (dt 0.25, h 1)."""
    import numpy as np

    from mlqem_tpu_torch.ops.frame_trajectory import frame_plan
    from mlqem_tpu_torch.parallel.datagen import make_ising_template

    tpl = make_ising_template(nq, steps, "Z", 0.25, h=1.0)
    plan, meta = frame_plan(tpl.bind_host(
        np.zeros(tpl.num_parameters, np.float32)))
    return plan, len(meta)


def k2_tier(plan, nq, n_rot):
    """How K2 runs a plan at nq: its tier, passes and relayouts."""
    import mlqem_tpu_torch.ops.kernels.frame_evolve as kfe

    if nq <= kfe.MAX_WARP_NQ:
        return " (warp tier)"
    sched = kfe.frame_schedule(kfe.check_plan(plan, nq, n_rot), nq)
    where = "on chip" if nq <= kfe.MAX_SMEM_NQ else "device memory"
    return (f" ({where}: {len(sched.passes)} pass"
            f"{'es' if len(sched.passes) > 1 else ''}, "
            f"{sched.relayouts} relayouts)")


def parent_k2(source):
    """K2's launch from the build of ``source``, a copy of
    ``csrc/frame_evolve.cu`` as it was before the tiers above 10 qubits
    were redesigned (its C entry point without pass records): a function
    (theta, plan, nq) -> out, on the current stream."""
    import ctypes

    import numpy as np
    import torch

    import mlqem_tpu_torch.ops.kernels.frame_evolve as kfe
    from mlqem_tpu_torch.utils import build

    source = os.path.abspath(source)
    lib = build._build(
        build._hashed_path("frame_evolve_parent", [source], build.NVCC_FLAGS),
        [build.find_nvcc(), *build.NVCC_FLAGS, source], timeout=600)
    fn = lib.evolve_frame_marginals_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(theta, plan, nq):
        rows, n_rot = theta.shape
        plan = kfe.fuse_plan(kfe.check_plan(plan, nq, n_rot))
        sms = torch.cuda.get_device_properties(
            theta.device).multi_processor_count
        slots = (0 if nq <= 13 else
                 max(1, min(rows, 4 * sms, (1 << 30) // (8 << nq))))
        out = torch.empty((rows, nq), device=theta.device)
        ops = torch.as_tensor(np.asarray(plan, np.int32).reshape(-1, 4),
                              device=theta.device)
        scratch = torch.empty((slots, 2, 1 << nq) if slots else (0,),
                              device=theta.device)
        err = fn(theta.data_ptr(), ops.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), slots, rows, nq, len(plan), n_rot,
                 torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"the parent's K2 launch failed: CUDA error {err}")
        return out

    return run


def k2_tier_times(card, cuda, parent=None):
    """K2 on the Ising template (2 steps) at each tier's widths
    (``K2_TIER_ROWS``) against its plain version: max|Δ| ≤ K2_TOL, the
    kernel's time (and, with ``parent``, the parent build's, in turns:
    parent, change, change, parent), the plain version's, the bound."""
    import numpy as np
    import torch

    import mlqem_tpu_torch.ops.kernels.frame_evolve as kfe

    rng = np.random.default_rng(22)
    for nq, rows in K2_TIER_ROWS:
        plan, n_rot = ising_plan(nq)
        theta = torch.as_tensor(rng.uniform(-3, 3, size=(rows, n_rot)),
                                dtype=torch.float32, device=cuda)
        got = kfe.evolve_frame_marginals(theta, plan, nq)
        want = kfe.evolve_frame_marginals_reference(theta, plan, nq)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        del got, want
        require(err <= K2_TOL, f"K2 at nq={nq} on the Ising template "
                f"disagrees with its plain version: {err}")

        def run_kernel():
            kfe.evolve_frame_marginals(theta, plan, nq)

        def run_plain():
            kfe.evolve_frame_marginals_reference(theta, plan, nq)

        k_ms, p_ms, kernel_ms, plain_ms = time_kernel_and_plain(
            run_kernel, run_plain, 1)
        line = ""
        if parent is not None:
            parent_err = (parent(theta, plan, nq) - kfe.evolve_frame_marginals(
                theta, plan, nq)).abs().max().item()

            def run_parent():
                parent(theta, plan, nq)

            run_parent()
            par_ms, ch_ms = [time_ms(run_parent, 5)], []
            ch_ms += [time_ms(run_kernel, 5), time_ms(run_kernel, 5)]
            par_ms.append(time_ms(run_parent, 5))
            line = (f"; in turns: parent {par_ms[0]:.3f}, change "
                    f"{ch_ms[0]:.3f}, change {ch_ms[1]:.3f}, parent "
                    f"{par_ms[1]:.3f} ms (parent vs change max|Δ| "
                    f"{parent_err:.3e})")
        fused = kfe.fuse_plan(kfe.check_plan(plan, nq, n_rot))
        k2_bound = bound(4 * theta.numel() + 4 * rows * nq + 16 * len(fused),
                         rows * plan_flops(fused, nq))
        print(f"  K2 tier nq={nq} rows={rows} ops={len(plan)} (run as "
              f"{len(fused)}){k2_tier(plan, nq, n_rot)}: max|Δ|={err:.3e}; "
              f"kernel {k_ms:.3f} ms (runs "
              f"{[round(x, 3) for x in kernel_ms]}), plain PyTorch "
              f"{p_ms:.3f} ms (runs {[round(x, 3) for x in plain_ms]}); "
              f"bound {k2_bound[0]:.3f} ms ({k2_bound[1]}), "
              f"{k_ms / k2_bound[0]:.1f}x{line} [{card}]")
        del theta
        torch.cuda.empty_cache()


def exact_states(J, nq, steps, dt, h=1.0):
    """Independent check: the Trotter circuit's states by complex128
    statevector simulation (RX(2h·dt) on every qubit, gate by gate, then
    RZZ(−2J·dt) on every bond, as one diagonal): [len(J), 2^nq]."""
    import numpy as np

    dim = 2 ** nq
    bits = (np.arange(dim)[:, None] >> np.arange(nq)[None, :]) & 1
    z = 1.0 - 2.0 * bits                              # Z_q eigenvalues
    c, s = np.cos(h * dt), np.sin(h * dt)             # RX(θ), θ/2 = h·dt
    # the RZZ gates are diagonal and commute: one phase per step, from the
    # sum of z_a·z_b over the bonds
    zz = sum(z[:, q] * z[:, q + 1] for q in range(nq - 1))
    out = []
    for jv in J:
        psi = np.zeros(dim, np.complex128)
        psi[0] = 1.0
        zz_phase = np.exp(-0.5j * (-2.0 * float(jv) * dt) * zz)
        for _ in range(steps):
            for q in range(nq):
                v = psi.reshape(dim // 2 ** (q + 1), 2, 2 ** q)
                a, b = v[:, 0, :].copy(), v[:, 1, :].copy()
                v[:, 0, :] = c * a - 1j * s * b
                v[:, 1, :] = -1j * s * a + c * b
            psi = psi * zz_phase
        out.append(psi)
    return np.stack(out)


def exact_ideal_z(J, nq, steps, dt, h=1.0):
    """Independent check: ⟨Z_q⟩ of the Trotter circuit (:func:`exact_states`)."""
    import numpy as np

    dim = 2 ** nq
    z = 1.0 - 2.0 * ((np.arange(dim)[:, None] >> np.arange(nq)[None, :]) & 1)
    return (np.abs(exact_states(J, nq, steps, dt, h)) ** 2) @ z


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
                     (10, 3001), (11, 129), (12, 67), (13, 257), (14, 600),
                     (15, 5), (16, 9), (18, 3), (20, 2)]:
        plans = [("random plan of every kind",
                  kfe.every_kind_plan(rng, nq, 148)),
                 ("every qubit moved by every kind",
                  kfe.every_path_plan(rng, nq))]
        if nq > kfe.MAX_WARP_NQ:
            plans.append(("the Ising template, 2 steps", ising_plan(nq)))
        for label, (plan, n_rot) in plans:
            theta = torch.as_tensor(rng.uniform(-3, 3, size=(rows, n_rot)),
                                    dtype=torch.float32, device=cuda)
            got = kfe.evolve_frame_marginals(theta, plan, nq)
            want = kfe.evolve_frame_marginals_reference(theta, plan, nq)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            print(f"K2 vs plain: {label}, nq={nq} rows={rows} "
                  f"ops={len(plan)}{k2_tier(plan, nq, n_rot)} "
                  f"max|Δ|={err:.3e}")
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
    theta = torch.as_tensor(np.random.default_rng(10).uniform(
        -3, 3, size=(K2_CHECK_ROWS, len(rot_meta))), dtype=torch.float32,
        device=cuda)
    digest = hashlib.sha256(kfe.evolve_frame_marginals(
        theta, plan, NQ).cpu().numpy().tobytes()).hexdigest()
    print(f"K2 at nq={NQ} on the bench plan: SHA-256 {digest} (before the "
          f"redesign of the tiers above 10 qubits: {K2_DIGEST})")
    require(digest == K2_DIGEST, "K2's warp tier (nq <= 10) changed its "
            "outputs")

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
    RESULTS["crosscheck"] = xck

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

# -- the exact density-matrix path and the Estimator API (phases 13-14) ------
def np_gate(name, params):
    """Independent check: the few gates of the Ising circuit and of the
    measurement rotations; cx is 4x4 on (control = MSB, target = LSB)."""
    import numpy as np

    if name == "cx":
        return np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1],
                         [0, 0, 1, 0]], np.complex128)
    if name == "rx":
        c, s = np.cos(params[0] / 2), np.sin(params[0] / 2)
        return np.array([[c, -1j * s], [-1j * s, c]])
    if name == "rz":
        return np.diag([np.exp(-0.5j * params[0]), np.exp(0.5j * params[0])])
    if name == "h":
        return np.array([[1, 1], [1, -1]]) / np.sqrt(2)
    if name == "sdg":
        return np.diag([1, -1j])
    raise ValueError(f"no numpy check for gate {name!r}")


def np_relax(t1, t2, time):
    """Independent check: thermal relaxation over ``time`` as a 1q superop
    on vec(ρ) (index 2·row + col): |1⟩ decays to |0⟩ at T1, coherences by
    e^(−t/T2) but never slower than T1 forces."""
    import numpy as np

    gamma = 1.0 - np.exp(-time / t1) if t1 > 0 else 0.0
    decay = np.exp(-time / t2) if t2 > 0 else 1.0
    coh = min(decay, np.sqrt(1.0 - gamma))
    s = np.zeros((4, 4))
    s[0, 0], s[0, 3], s[3, 3] = 1.0, gamma, 1.0 - gamma
    s[1, 1] = s[2, 2] = coh
    return s


def np_gate_noise(calib, name, qubits):
    """Independent check: the noise after a gate, built from the device's
    calibration (``DeviceModel.to_dict()``) as Aer's ``from_backend`` does:
    depolarizing of the strength that makes the composite reach the gate's
    calibrated average infidelity, then thermal relaxation of each qubit
    over the gate's length. A superop on vec(ρ) of the op's qubits (the
    first = MSB), or None for rz and gates without calibration."""
    import numpy as np

    key = "_".join([name] + [str(q) for q in qubits])
    props = calib["gates"].get(key)
    if props is None and len(qubits) == 2:
        props = calib["gates"].get(f"{name}_{qubits[1]}_{qubits[0]}")
    if name == "rz" or props is None:
        return None
    k = len(qubits)
    d = 2 ** k
    s = np.eye(d * d)
    if props["gate_length"] > 0:
        rel = [np_relax(calib["qubits"][q]["t1"], calib["qubits"][q]["t2"],
                        props["gate_length"]).reshape(2, 2, 2, 2)
               for q in qubits]
        s = rel[0].reshape(4, 4) if k == 1 else np.einsum(
            "ijkl,mnop->imjnkolp", *rel).reshape(16, 16)
    err = min(props["gate_error"], 1.0 - 4.0 ** -k)
    if err > 0:
        f_target = ((d + 1) * (1.0 - err) - 1.0) / d     # process fidelity
        f_relax = float(np.trace(s).real) / d ** 2
        p = 0.0
        if f_relax > 1.0 / d ** 2:
            p = min(max((f_relax - f_target) / (f_relax - 1.0 / d ** 2),
                        0.0), 1.0)
        vec_id = np.eye(d).reshape(-1)
        dep = (1.0 - p) * np.eye(d * d) + p / d * np.outer(vec_id, vec_id)
        s = s @ dep                        # depolarizing first, then relax
    return s


def np_confusion(calib):
    """Independent check: per-qubit readout confusion M[meas, true] from
    the calibrated symmetric flip probabilities, [nq, 2, 2]."""
    import numpy as np

    p = [min(q["readout_error"], 0.5) for q in calib["qubits"]]
    return np.array([[[1.0 - x, x], [x, 1.0 - x]] for x in p])


def np_apply_superop(rho, s, qubits):
    """Apply a superop on vec(ρ) of ``qubits`` (the first = MSB) to the
    row and column bit axes of a [2]*(2n) density matrix."""
    import numpy as np

    n, k = rho.ndim // 2, len(qubits)
    axes = [n - 1 - q for q in qubits] + [2 * n - 1 - q for q in qubits]
    out = np.tensordot(s.reshape((2,) * (4 * k)), rho,
                       axes=(list(range(2 * k, 4 * k)), axes))
    return np.moveaxis(out, list(range(2 * k)), axes)


def np_noisy_dm(circuit, calib, rho=None):
    """Independent check: the complex128 density matrix of a circuit under
    its device's calibrated noise, as a [2]*(2n) tensor: each op's
    kron(U, conj U), then its noise (:func:`np_gate_noise`), applied to the
    op's row and column bit axes by ``np.tensordot``."""
    import numpy as np

    n = circuit.num_qubits
    if rho is None:
        rho = np.zeros((2,) * (2 * n), np.complex128)
        rho[(0,) * (2 * n)] = 1.0
    for op in circuit.ops:
        if op.name in ("barrier", "measure"):
            continue
        u = np_gate(op.name, op.params)
        rho = np_apply_superop(rho, np.kron(u, u.conj()), op.qubits)
        noise = np_gate_noise(calib, op.name, op.qubits)
        if noise is not None:
            rho = np_apply_superop(rho, noise, op.qubits)
    return rho


def np_readout_parity(rho, confusion, support):
    """⟨(−1)^(Σ measured bits over support)⟩ of a [2]*(2n) density matrix
    under per-qubit confusion M[meas, true]: Σ_t p(t) Π_q (M[0,t_q] −
    M[1,t_q])."""
    import numpy as np

    n = rho.ndim // 2
    dim = 2 ** n
    p = np.real(np.diagonal(rho.reshape(dim, dim))).reshape((2,) * n)
    for q in range(n):
        if (support >> q) & 1:
            m = np.eye(2) if confusion is None else np.asarray(confusion[q])
            f = m[0] - m[1]                           # over the true bit
            shape = [1] * n
            shape[n - 1 - q] = 2
            p = p * f.reshape(shape)
    return float(p.sum())


def np_pauli_value(rho, term, confusion, calib):
    """Independent check: a Pauli term measured as the Estimator measures
    it: rotate its X (H) and Y (Sdg, H) qubits with their noise, then the
    readout-confused parity over its support."""
    from mlqem_tpu_torch import Circuit

    n = rho.ndim // 2
    rot = Circuit(n)
    for q, c in enumerate(reversed(term.pauli)):
        if c == "X":
            rot.h(q)
        elif c == "Y":
            rot.sdg(q).h(q)
    if rot.ops:
        rho = np_noisy_dm(rot, calib, rho)
    x, z = term.masks()
    return float(term.coeff.real) * np_readout_parity(rho, confusion, x | z)


def np_pauli_ideal(psi, term):
    """⟨ψ|P|ψ⟩ with P applied qubit by qubit to the complex128 state."""
    import numpy as np

    n = int(np.log2(psi.size))
    mats = {"X": [[0, 1], [1, 0]], "Y": [[0, -1j], [1j, 0]],
            "Z": [[1, 0], [0, -1]]}
    phi = psi.reshape((2,) * n)
    for q, c in enumerate(reversed(term.pauli)):
        if c != "I":
            phi = np.moveaxis(np.tensordot(np.array(mats[c]), phi,
                                           axes=([1], [n - 1 - q])),
                              0, n - 1 - q)
    return float(term.coeff.real * np.vdot(psi, phi.reshape(-1)).real)


def sync_s(fn):
    """Host seconds of ``fn()`` ending in a synchronize, and its result."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def density_phases(card, cuda, device_model):
    """Phase 13: IsingLabelPipeline(method="density_matrix") at bench.py's
    --method density_matrix configuration: checks, then timing. Returns
    (J of the first checked circuit, its numpy density matrix)."""
    import numpy as np
    import torch

    from mlqem_tpu_torch import IsingLabelPipeline
    from mlqem_tpu_torch.circuits.circuit import CircuitTensor
    from mlqem_tpu_torch.circuits.families import IsingModel, IsingOptions
    from mlqem_tpu_torch.ops.density import batch_density_matrices
    from mlqem_tpu_torch.ops.density_static import (apply_superop_static,
                                                    run_density_static,
                                                    superop_plan)

    torch.cuda.empty_cache()
    rng = np.random.default_rng(13)
    t0 = time.perf_counter()
    pipe = IsingLabelPipeline(device_model, nq=NQ, steps=STEPS, dt=DT, h=1.0,
                              shots=SHOTS, method="density_matrix",
                              device=cuda)
    tables_s = time.perf_counter() - t0
    exact_pipe = IsingLabelPipeline(device_model, nq=NQ, steps=STEPS, dt=DT,
                                    h=1.0, shots=None, device=cuda)
    J = rng.uniform(0.05, 0.6, size=DM_BATCH).astype(np.float32)
    reset_launches()
    ideal, noisy = pipe.generate(J, seed=0)
    torch.cuda.synchronize()
    counts = read_launches()
    print(f"dm path: 1 batch of {DM_BATCH} circuits, {SHOTS} shots: "
          f"launches {counts} (no kernel on this path)")
    require(not any(counts.values()), f"a kernel ran on the dm path: "
            f"{counts}")
    for name, lab in (("ideal", ideal), ("noisy", noisy)):
        require(lab.shape == (DM_BATCH, NQ), f"dm {name} shape {lab.shape}")
        require(bool(np.isfinite(lab).all()), f"dm {name} not finite")
        require(bool((np.abs(lab) <= 1.0 + 1e-6).all()),
                f"dm {name} leaves [-1, 1]")
    ideal_err = float(np.abs(ideal[:4] - exact_ideal_z(J[:4], NQ, STEPS,
                                                       DT)).max())
    print(f"dm path ideal labels vs complex128 statevector (4 circuits): "
          f"max|Δ|={ideal_err:.3e}")
    require(ideal_err <= TOL, f"dm path ideal labels wrong: {ideal_err}")

    # shots=None against an independent complex128 density matrix
    _, z_exact = exact_pipe.generate(J, seed=0)
    calib = device_model.to_dict()
    confusion = np_confusion(calib)
    t0 = time.perf_counter()
    rhos, np_err = [], 0.0
    for k in range(DM_NP_CHECK):
        qc = IsingModel.make_circuit(IsingOptions(
            nq=NQ, h=1.0, J=float(J[k]), dt=DT, depth=STEPS), measure=False)
        rhos.append(np_noisy_dm(qc, calib))
        want = [np_readout_parity(rhos[-1], confusion, 1 << q)
                for q in range(NQ)]
        np_err = max(np_err, float(np.abs(z_exact[k] - want).max()))
    print(f"dm path shots=None noisy labels vs complex128 numpy density "
          f"matrix ({DM_NP_CHECK} circuits, readout on): max|Δ|="
          f"{np_err:.3e} ({time.perf_counter() - t0:.1f} s on the host)")
    require(np_err <= TOL, f"dm noisy labels disagree with numpy: {np_err}")

    # the engines against each other on a few circuits
    vals = torch.as_tensor(pipe.params_from_values(J[:DM_CHECK]),
                           device=cuda)
    params = pipe.template.bind(vals).params
    fused = run_density_static(pipe.ct_struct, params, pipe._keys,
                               pipe._table)
    engines = {
        "fuse=False": run_density_static(pipe.ct_struct, params, pipe._keys,
                                         pipe._table, fuse=False),
        "pair4": run_density_static(pipe.ct_struct, params, pipe._keys,
                                    pipe._table, pair4=True),
        "gather engine (batch_density_matrices)": batch_density_matrices(
            CircuitTensor(
                np.broadcast_to(pipe.ct_struct.gate_ids,
                                (DM_CHECK,) + pipe.ct_struct.gate_ids.shape),
                np.broadcast_to(pipe.ct_struct.qubits,
                                (DM_CHECK,) + pipe.ct_struct.qubits.shape),
                params, NQ),
            np.broadcast_to(pipe._keys, (DM_CHECK,) + pipe._keys.shape),
            pipe._table, device=cuda)}
    for name, dm in engines.items():
        err = (dm - fused).abs().max().item()
        print(f"dm engines, {DM_CHECK} circuits: {name} vs fused "
              f"run_density_static max|Δ|={err:.3e}")
        require(err <= TOL, f"{name} disagrees with the fused engine: {err}")
    trace_err = (torch.diagonal(fused, dim1=-2, dim2=-1).sum(-1) - 1).abs(
        ).max().item()
    print(f"dm unit trace: max|tr ρ − 1|={trace_err:.3e}")
    require(trace_err <= TOL, f"dm trace off by {trace_err}")
    del fused, engines

    # joint shots against shots=None
    sigma = np.sqrt(np.clip(1.0 - z_exact ** 2, 0.0, None) / SHOTS)
    dev_sig = np.abs(noisy - z_exact) / np.maximum(sigma, 1e-12)
    print(f"dm path {SHOTS} joint shots vs shots=None: max |Δ|/σ = "
          f"{dev_sig.max():.2f} over {dev_sig.size} labels")
    require(bool((np.abs(noisy - z_exact) <= 5 * sigma + 1e-6).all()),
            "dm shots stray beyond 5 standard errors")

    # -- timing --------------------------------------------------------------
    time_batches(pipe.generate, J, rng, card, "dm path ")
    pvals = torch.as_tensor(pipe.params_from_values(J), device=cuda)
    split = stage_split(lambda gen, mark: pipe.run(pvals, gen, mark=mark),
                        cuda)
    n_ops = len(superop_plan(pipe.ct_struct, pipe.template.bind(
        pvals[:1]).params, pipe._keys, pipe._table))
    dm_bytes = DM_BATCH * 4 ** NQ * 8
    pass_bound_ms = 2 * dm_bytes / HBM_BYTES_PER_S * 1e3
    print(f"dm path stage split (median of 3 batches, synchronized per "
          f"stage) [{card}]:")
    print(f"  (a) noise tables + template (host, once per pipeline): "
          f"{tables_s * 1e3:.1f} ms")
    print(f"  (b) op unitaries + fused superop plan ({n_ops} superops from "
          f"{pipe.ct_struct.max_ops} slots): {split['frame']:.1f} ms")
    print(f"  (c) superop sweep, {n_ops} passes over {DM_BATCH} x 2^{2 * NQ} "
          f"complex64 ({dm_bytes / 1e9:.2f} GB): {split['evolve']:.1f} ms = "
          f"{split['evolve'] / n_ops:.2f} ms a pass; bound {pass_bound_ms:.2f}"
          f" ms a pass (one read + one write over {HBM_BYTES_PER_S / 1e12} "
          f"TB/s), {n_ops * pass_bound_ms:.1f} ms a sweep")
    print(f"  (d) readout confusion + {SHOTS} joint shots: "
          f"{split['readout']:.1f} ms")
    print(f"  (c') ideal arm (statevector, {DM_BATCH} circuits, + <Z>): "
          f"{split['ideal']:.1f} ms")

    # one pass alone, at three qubit pairs, beside a plain copy of the batch
    dm = torch.zeros((DM_BATCH, 2 ** NQ, 2 ** NQ), dtype=torch.complex64,
                     device=cuda)
    dm[:, 0, 0] = 1.0
    s16 = torch.eye(16, dtype=torch.complex64, device=cuda).expand(
        DM_BATCH, 16, 16).contiguous()
    pass_ms = {}
    for a, b in ((0, 1), (5, 4), (9, 8), (0, 9)):
        apply_superop_static(dm, s16, a, b, NQ)
        pass_ms[(a, b)] = min(time_ms(lambda: apply_superop_static(
            dm, s16, a, b, NQ), 3) for _ in range(2))
    copy_ms = min(time_ms(lambda: dm.clone(), 3) for _ in range(2))
    print(f"apply_superop_static alone on {DM_BATCH} x 2^{2 * NQ} complex64 "
          f"(CUDA events, best of 2 x 3): " + ", ".join(
              f"(a, b)={ab} {ms:.2f} ms" for ab, ms in pass_ms.items())
          + f"; a clone of the batch (one read + one write) {copy_ms:.2f} ms"
          f"; bound {pass_bound_ms:.2f} ms [{card}]")
    del dm, s16
    torch.cuda.empty_cache()

    # pair4 on against off, in turns, same inputs
    params = pipe.template.bind(pvals).params
    pair_s, probs = {False: [], True: []}, {}
    for pair4 in (False, True, True, False):
        secs, dm = sync_s(lambda: run_density_static(
            pipe.ct_struct, params, pipe._keys, pipe._table, pair4=pair4))
        pair_s[pair4].append(secs)
        probs[pair4] = torch.diagonal(dm, dim1=-2, dim2=-1).real.clone()
        del dm
    n4 = len(superop_plan(pipe.ct_struct, params[:1], pipe._keys,
                          pipe._table, pair4=True))
    pair_err = (probs[True] - probs[False]).abs().max().item()
    print(f"dm sweep pair4 off ({n_ops} passes) vs on ({n4} passes, "
          f"256x256 superops) at {DM_BATCH} circuits, plan + sweep, "
          f"off/on/on/off: off {[round(x * 1e3, 1) for x in pair_s[False]]} "
          f"ms, on {[round(x * 1e3, 1) for x in pair_s[True]]} ms; "
          f"diagonals max|Δ|={pair_err:.3e} [{card}]")
    require(pair_err <= TOL, f"pair4 disagrees: {pair_err}")
    del probs, params
    torch.cuda.empty_cache()

    # the batch cap: one batch of DM_CAP_BATCH circuits
    Jc = rng.uniform(0.05, 0.6, size=DM_CAP_BATCH).astype(np.float32)
    torch.cuda.reset_peak_memory_stats()
    secs, (ideal_c, noisy_c) = sync_s(lambda: pipe.generate(Jc, seed=3))
    peak = torch.cuda.max_memory_allocated()
    require(noisy_c.shape == (DM_CAP_BATCH, NQ)
            and bool(np.isfinite(noisy_c).all()), "dm cap batch failed")
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"dm path at {DM_CAP_BATCH} circuits: {secs * 1e3:.1f} ms a batch "
          f"({DM_CAP_BATCH * 60.0 / secs:.0f} pairs/min), peak "
          f"{peak / 2 ** 30:.2f} GiB = {peak / DM_CAP_BATCH / 2 ** 20:.2f} "
          f"MiB a circuit of {total / 2 ** 30:.1f} GiB: cap ≈ "
          f"{int(total / (peak / DM_CAP_BATCH))} circuits a batch [{card}]")
    torch.cuda.empty_cache()
    return float(J[0]), rhos[0]


def estimator_phase(card, cuda, device_model, J0, rho0):
    """Phase 14: the Estimator API on the card at full width: the ideal,
    noisy (exact and shots), counts and trajectory backends and ZNE on the
    10-qubit Ising circuit of phase 13's first check."""
    import numpy as np
    import torch

    from mlqem_tpu_torch import (CountsBackend, IdealEstimator,
                                 NoisyEstimator, PauliSum,
                                 TrajectoryEstimator, ZNEStrategy, zne)
    from mlqem_tpu_torch.circuits.families import IsingModel, IsingOptions
    from mlqem_tpu_torch.circuits.observables import single_z

    qc = IsingModel.make_circuit(IsingOptions(nq=NQ, h=1.0, J=J0, dt=DT,
                                              depth=STEPS), measure=False)
    obs = PauliSum([("I" * 9 + "Z", 1.0), ("I" * 8 + "XX", 0.5),
                    ("I" * 4 + "Y" + "I" * 5, 0.3)])
    coeff_sum = sum(abs(t.coeff) for t in obs.terms)
    calib = device_model.to_dict()
    confusion = np_confusion(calib)
    psi = exact_states([J0], NQ, STEPS, DT)[0]
    want_ideal = sum(np_pauli_ideal(psi, t) for t in obs.terms)
    want_noisy = sum(np_pauli_value(rho0, t, confusion, calib)
                     for t in obs.terms)
    z_qubits = (0, 3, 6, 9)
    z_obs = [single_z(q, NQ) for q in z_qubits]
    z_ideal = [np_pauli_ideal(psi, o.terms[0]) for o in z_obs]

    zne_cls = zne(NoisyEstimator)
    reset_launches()
    secs, vals = {}, {}
    runs = {
        "IdealEstimator": lambda: IdealEstimator(device=cuda).run(qc, obs),
        "NoisyEstimator shots=None": lambda: NoisyEstimator(
            device_model, device=cuda).run(qc, obs),
        f"NoisyEstimator shots={SHOTS}": lambda: NoisyEstimator(
            device_model, shots=SHOTS, seed=14, device=cuda).run(qc, obs),
        f"TrajectoryEstimator n_traj={EST_TRAJ}": lambda: TrajectoryEstimator(
            device_model, n_traj=EST_TRAJ, seed=14, device=cuda).run(qc, obs),
        "NoisyEstimator readout=False, Z terms": lambda: NoisyEstimator(
            device_model, readout=False, device=cuda).run(
                [qc] * len(z_obs), z_obs),
        "zne(NoisyEstimator) readout=False, noise factors (1, 3, 5), "
        "Z terms": lambda: zne_cls(
            device_model, readout=False, device=cuda,
            zne_strategy=ZNEStrategy(noise_factors=(1, 3, 5))).run(
                [qc] * len(z_obs), z_obs),
    }
    for name, run in runs.items():
        secs[name], job = sync_s(lambda: run().result().values)
        vals[name] = job
    backend = CountsBackend(device_model, seed=14, device=cuda)
    secs["CountsBackend"], probs = sync_s(lambda: backend.run_probs([qc]))
    counts = backend.run_counts([qc], shots=SHOTS)[0]
    launches = read_launches()
    print(f"Estimator API on the Ising circuit (nq={NQ}, {STEPS} steps, "
          f"J={J0:.4f}), observable {obs}: launches {launches} (no kernel "
          f"on this path)")
    require(not any(launches.values()), f"a kernel ran: {launches}")
    for name in runs:
        print(f"  {name}: {np.round(vals[name], 6).tolist()} "
              f"({secs[name] * 1e3:.1f} ms) [{card}]")
    print(f"  CountsBackend run_probs + run_counts: "
          f"{secs['CountsBackend'] * 1e3:.1f} ms [{card}]")

    ideal_err = abs(vals["IdealEstimator"][0] - want_ideal)
    noisy_err = abs(vals["NoisyEstimator shots=None"][0] - want_noisy)
    print(f"  ideal vs complex128 statevector: |Δ|={ideal_err:.3e}; noisy "
          f"(readout on) vs phase 13's numpy density matrix with noisy "
          f"rotations: |Δ|={noisy_err:.3e}")
    require(ideal_err <= TOL, f"IdealEstimator wrong: {ideal_err}")
    require(noisy_err <= TOL, f"NoisyEstimator wrong: {noisy_err}")
    exact = vals["NoisyEstimator shots=None"][0]
    for name, n in ((f"NoisyEstimator shots={SHOTS}", SHOTS),
                    (f"TrajectoryEstimator n_traj={EST_TRAJ}", EST_TRAJ)):
        sigma = coeff_sum / np.sqrt(n)        # each term's samples in [-1, 1]
        d = abs(vals[name][0] - exact)
        print(f"  {name} vs shots=None: |Δ|={d:.4f} = {d / sigma:.2f} σ "
              f"(σ ≤ Σ|c|/√{n} = {sigma:.4f})")
        require(d <= 5 * sigma, f"{name} strays {d / sigma:.2f} σ")

    dim = 2 ** NQ
    want_probs = np.real(np.diagonal(rho0.reshape(dim, dim)))
    conf_probs = want_probs.reshape((2,) * NQ)
    for q in range(NQ):                   # confusion on each qubit's axis
        conf_probs = np.moveaxis(np.tensordot(
            confusion[q], conf_probs, axes=([1], [NQ - 1 - q])), 0,
            NQ - 1 - q)
    probs_err = float(np.abs(probs[0] - conf_probs.reshape(-1)).max())
    z_counts = np.array([sum(c * (1 - 2 * int(bits[NQ - 1 - q]))
                             for bits, c in counts.items()) / SHOTS
                         for q in range(NQ)])
    z_probs = [np_readout_parity(rho0, confusion, 1 << q) for q in range(NQ)]
    count_dev = float(np.abs(z_counts - z_probs).max() * np.sqrt(SHOTS))
    print(f"  CountsBackend: probabilities vs numpy max|Δ|={probs_err:.3e}; "
          f"{sum(counts.values())} counts, per-qubit <Z> max |Δ|/σ ≤ "
          f"{count_dev:.2f}")
    require(probs_err <= TOL, f"CountsBackend probabilities: {probs_err}")
    require(sum(counts.values()) == SHOTS and count_dev <= 5.0,
            "CountsBackend counts stray")

    z_noisy = vals["NoisyEstimator readout=False, Z terms"]
    z_zne = vals["zne(NoisyEstimator) readout=False, noise factors (1, 3, 5)"
                 ", Z terms"]
    for q, i, n_, m in zip(z_qubits, z_ideal, z_noisy, z_zne):
        print(f"  Z_{q}: ideal {i:.5f}, noisy {n_:.5f} (|Δ| "
              f"{abs(n_ - i):.5f}), ZNE {m:.5f} (|Δ| {abs(m - i):.5f})")
        require(abs(m - i) < abs(n_ - i), f"ZNE did not move Z_{q} toward "
                f"the ideal value")


# -- the learning stack (phases 15-16) ----------------------------------------
def decode_observable(row, nq):
    """The PauliSum of one ``encode_pauli_sum_op`` row: [coeff, then per
    qubit the one-hot over I, Z, Y, X, leftmost = highest qubit]."""
    import numpy as np

    from mlqem_tpu_torch import PauliSum

    pauli = "".join("IZYX"[int(np.argmax(row[1 + 4 * k:5 + 4 * k]))]
                    for k in range(nq))
    return PauliSum([(pauli, float(row[0]))])


def device_busy(fn, reps):
    """Device kernel time against wall time of ``reps`` calls of ``fn``
    under ``torch.profiler`` (CUPTI), as a line of text."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_us = sum(e.self_device_time_total for e in rows)
    if not kernel_us:
        return "device time not measured (the profiler saw no kernel)"
    launches = sum(e.count for e in rows)
    return (f"{launches / reps:.0f} kernels a call, device busy "
            f"{kernel_us / reps / 1e3:.3f} ms of {wall_us / reps / 1e3:.3f} "
            f"ms wall a call (profiled) = {100 * kernel_us / wall_us:.1f}% "
            f"busy, {100 - 100 * kernel_us / wall_us:.1f}% idle")


def learning_flat_phase(card, cuda):
    """Phase 15: the flat-feature path on the card: the tomography sweep,
    the forest (fit on the host, predict on the card) against the same
    forest on the CPU, learning(NoisyEstimator) with it, and MLP1 on the
    58-dim features."""
    import numpy as np
    import torch

    from mlqem_tpu_torch import (MLP1, IdealEstimator, NoisyEstimator,
                                 RandomForestRegressor, generate_exp_val_dataset,
                                 get_device, learning, tomography_sweep,
                                 train_mlp)
    from mlqem_tpu_torch.circuits.circuit import Circuit
    from mlqem_tpu_torch.circuits.observables import PauliSum, PauliTerm, \
        single_z
    from mlqem_tpu_torch.data.encoders import encode_data, encode_pauli_sum_op
    from mlqem_tpu_torch.mitigation.learning import ModelProcessor
    from mlqem_tpu_torch.transpile.lower import transpile
    from mlqem_tpu_torch.workflows.gnn_training import tomography_features

    dev = get_device("fake_lima")
    props = dev.properties()
    reset_launches()
    t0 = time.perf_counter()
    secs, rows = sync_s(lambda: tomography_sweep(
        dev, train_sizes=(16, 128), test_size=40, seed=3, device=cuda))
    print(f"tomography_sweep(fake_lima, (16, 128), test 40, seed 3): "
          + "; ".join(f"{r['train_size']} → mitigated RMSE "
                      f"{r['rmse_mitigated']:.4f}" for r in rows)
          + f" (noisy {rows[0]['rmse_noisy']:.4f}); {secs:.2f} s [{card}]")
    require(rows[1]["rmse_mitigated"] < rows[0]["rmse_mitigated"],
            "the tomography sweep did not improve with more data")

    # the sweep's own dataset and features (168 entries, 3 qubits)
    entries = generate_exp_val_dataset(dev, n_qubits=3, circuit_depth=3,
                                       num_entries=168, seed=3, device=cuda)
    X, y = tomography_features(entries, props)
    fit_s, rf = sync_s(lambda: RandomForestRegressor(
        100, random_state=3, device=cuda).fit(X[:128], y[:128]))
    rf_cpu = RandomForestRegressor(100, device="cpu").set_stacked(
        *[t.cpu().numpy() for t in rf._stacked], rf._depth)
    rf_cpu._single_output = rf._single_output
    err = float(np.abs(rf.predict(X[128:]) - rf_cpu.predict(X[128:])).max())
    big = np.tile(X, (4096 // len(X) + 1, 1))[:4096]
    rf.predict(big)
    pred_ms = {n: min(sync_s(lambda: rf.predict(big[:n]))[0]
                      for _ in range(5)) * 1e3 for n in (40, 4096)}
    print(f"RandomForestRegressor(100) on {X.shape[1]} features: fit on the "
          f"host (128 rows) {fit_s:.2f} s, depth {rf._depth}, "
          f"{rf._stacked[0].shape[1]} nodes a tree; predict on the card vs "
          f"the CPU max|Δ|={err:.3e}; predict {pred_ms[40]:.2f} ms at 40 "
          f"rows, {pred_ms[4096]:.2f} ms at 4096 rows (host in, host out, "
          f"best of 5) [{card}]")
    require(err <= 1e-6, f"forest predict on the card vs the CPU: {err}")

    circs = [Circuit.from_dict(e.circuit) for e in entries[128:136]]
    obs = [decode_observable(e.observable[0], 3) for e in entries[128:136]]
    res = learning(NoisyEstimator, ModelProcessor(rf, dev))(
        dev, device=cuda).run(circs, obs).result()
    want = []
    for c, o, m in zip(circs, obs, res.metadata):
        term = o.terms[0]
        Xq, _ = encode_data([transpile(c, basis=dev.basis_gates)], props,
                            [[0.0]], [[m["original_value"]]], 1,
                            meas_bases=encode_pauli_sum_op(PauliSum([
                                PauliTerm(term.pauli, 1.0)])))
        want.append(rf.predict(Xq)[0] * float(np.real(term.coeff)))
    err = float(np.abs(res.values - np.asarray(want)).max())
    print(f"learning(NoisyEstimator) + ModelProcessor(forest), 8 circuits: "
          f"vs the forest's predict on encode_data max|Δ|={err:.3e}")
    require(err <= 1e-6, f"learning(NoisyEstimator) disagrees: {err}")

    # MLP1(64, 4) on the 58-dim per-qubit features of 4-qubit circuits
    circs = [Circuit.from_dict(e.circuit) for e in generate_exp_val_dataset(
        dev, n_qubits=4, circuit_depth=3, num_entries=256, seed=15,
        device=cuda)]
    z = [single_z(q, 4) for q in range(4)]
    ideal = np.stack([IdealEstimator(device=cuda).run(circs, o).result()
                      .values for o in z], axis=1)
    noisy = np.stack([NoisyEstimator(dev, device=cuda).run(circs, o).result()
                      .values for o in z], axis=1)
    X4, y4 = encode_data(circs, props, ideal, noisy, 4)
    require(X4.shape == (256, 58), f"features {X4.shape}, not (256, 58)")
    secs, (_, hist) = sync_s(lambda: train_mlp(
        MLP1(64, 4, input_size=58), X4, y4, num_epochs=30, batch_size=32,
        learning_rate=3e-3, seed=0, device=cuda))
    losses = hist["train_loss"]
    print(f"train_mlp(MLP1(64, 4)) on 256 x 58 features, 30 epochs: train "
          f"loss {losses[0]:.5f} → {losses[-1]:.5f}, val "
          f"{hist['val_loss'][0]:.5f} → {min(hist['val_loss']):.5f} (best); "
          f"{secs:.2f} s [{card}]")
    require(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
            "MLP1's training loss did not fall")
    launches = read_launches()
    require(not any(launches.values()), f"a kernel ran: {launches}")
    torch.cuda.synchronize()
    print(f"phase 15 wall time {time.perf_counter() - t0:.1f} s [{card}]")


def learning_gnn_phase(card, cuda):
    """Phase 16: the GNN path on the card: the dataset, the paper's GNN
    against the CPU (forward, one Adam step), train_gnn_mitigation at its
    defaults, and ngem(NoisyEstimator) against predict."""
    import copy

    import numpy as np
    import torch

    from mlqem_tpu_torch import (ExpValCircuitGraphModel3, ExpValDataset,
                                 NoisyEstimator, generate_exp_val_dataset,
                                 get_device, ngem, predict,
                                 train_gnn_mitigation)
    from mlqem_tpu_torch.circuits.circuit import Circuit
    from mlqem_tpu_torch.data.encoders import encode_pauli_sum_op
    from mlqem_tpu_torch.data.generators import ExpValueEntry
    from mlqem_tpu_torch.data.graph import circuit_to_graph_data_json
    from mlqem_tpu_torch.models.mlp import Dropout, init_params
    from mlqem_tpu_torch.models.train import gnn_inputs, train_step

    dev = get_device("fake_lima")
    props = dev.properties()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    data_s, entries = sync_s(lambda: generate_exp_val_dataset(
        dev, n_qubits=4, circuit_depth=3, num_entries=200, seed=0,
        device=cuda))
    ideal = np.array([e.ideal_exp_value for e in entries])
    print(f"generate_exp_val_dataset(fake_lima, 4 qubits, depth ≤ 3, 200 "
          f"entries) on the card's Estimators: {data_s:.2f} s; "
          f"{int((np.abs(ideal) < 1e-6).sum())} of 200 ideal labels within "
          f"1e-6 of 0 [{card}]")

    arrays = dict(ExpValDataset(entries).arrays)
    arrays["observable"] = arrays["observable"].mean(axis=1)
    y = arrays.pop("y")[:, None]

    def batch(sel, device):
        b = {k: torch.as_tensor(v[sel], device=device)
             for k, v in arrays.items()}
        return gnn_inputs(b), torch.as_tensor(y[sel], device=device)

    cpu = ExpValCircuitGraphModel3(15, 1, num_node_features=22)
    init_params(cpu, torch.Generator().manual_seed(16))
    for m in cpu.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    gpu = copy.deepcopy(cpu).to(cuda)
    sel = np.arange(32)
    (args_c, y_c), (args_g, y_g) = batch(sel, "cpu"), batch(sel, cuda)
    with torch.no_grad():
        fwd_err = (gpu.eval()(*args_g).cpu()
                   - cpu.eval()(*args_c)).abs().max().item()
    for model, args, yb in ((cpu, args_c, y_c), (gpu, args_g, y_g)):
        train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3),
                   args, yb)
    # Adam's first step is lr·g/(|g| + 1e-8): where |g| < 1e-6 rounding
    # decides a step of up to lr (the null-gradient biases among them)
    grad_err = step_err = loose_err = 0.0
    n_loose = 0
    for p, q in zip(cpu.parameters(), gpu.parameters()):
        g = q.grad.cpu()
        grad_err = max(grad_err, (g - p.grad).abs().max().item())
        d = (q.detach().cpu() - p.detach()).abs()
        tight = torch.maximum(g.abs(), p.grad.abs()) >= 1e-6
        n_loose += int((~tight).sum())
        if tight.any():
            step_err = max(step_err, d[tight].max().item())
        if (~tight).any():
            loose_err = max(loose_err, d[~tight].max().item())
    stats_err = max((c.cpu() - b).abs().max().item()
                    for b, c in zip(cpu.buffers(), gpu.buffers()))
    n_params = sum(p.numel() for p in cpu.parameters())
    print(f"ExpValCircuitGraphModel3(hidden 15, heads 5/3), batch 32: eval "
          f"forward card vs CPU max|Δ|={fwd_err:.3e}; one Adam step "
          f"(dropout off): gradients max|Δ|={grad_err:.3e}, parameters "
          f"max|Δ|={step_err:.3e} where |g| ≥ 1e-6 ({n_params - n_loose} of "
          f"{n_params}), {loose_err:.3e} on the {n_loose} others (Adam's "
          f"bound: lr a side), running statistics {stats_err:.3e}")
    require(fwd_err <= 1e-5, f"GNN forward card vs CPU: {fwd_err}")
    require(grad_err <= 1e-5, f"gradients card vs CPU: {grad_err}")
    require(max(step_err, stats_err) <= 1e-5,
            f"one Adam step card vs CPU: {step_err}, {stats_err}")
    require(loose_err <= 2e-3, f"near-zero-gradient elements moved "
            f"{loose_err}")

    train_s, out = sync_s(lambda: train_gnn_mitigation(dev, entries=entries,
                                                       device=cuda))
    hist = out["history"]
    n_epochs = len(hist["val_loss"])
    print(f"train_gnn_mitigation (60 epochs, batch 32, 160 train / 40 test "
          f"entries): {train_s:.2f} s = {train_s / n_epochs:.3f} s per epoch;"
          f" val loss {hist['val_loss'][0]:.5f} → {min(hist['val_loss']):.5f}"
          f" (best); RMSE mitigated {out['rmse_mitigated']:.5f}, noisy "
          f"{out['rmse_noisy']:.5f} [{card}]")
    require(bool(np.isfinite(hist["train_loss"]).all()
                 and np.isfinite(hist["val_loss"]).all()),
            "the GNN's history is not finite")
    require(min(hist["val_loss"]) < hist["val_loss"][0],
            "the GNN's validation loss never fell below its first")

    model = copy.deepcopy(out["model"])
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    args, yb = batch(np.arange(32), cuda)
    step_ms = []
    for _ in range(25):
        secs, _ = sync_s(lambda: train_step(model, opt, args, yb))
        step_ms.append(secs * 1e3)
    busy = device_busy(lambda: train_step(model, opt, args, yb), 10)
    tiled = {k: np.concatenate([v] * 6)[:1024] for k, v in arrays.items()}
    predict(out["model"], None, gnn_inputs, tiled)
    pred_s = min(sync_s(lambda: predict(out["model"], None, gnn_inputs,
                                        tiled))[0] for _ in range(3))
    print(f"train step at batch 32 (synchronized): median "
          f"{statistics.median(step_ms[5:]):.2f} ms (of 20 after 5 warm-up; "
          f"range {min(step_ms[5:]):.2f}-{max(step_ms[5:]):.2f}); predict at "
          f"batch 256: {1024 / pred_s:.0f} graphs/s (1024 graphs, host in, "
          f"host out, best of 3) [{card}]")
    print(f"train step, torch.profiler over 10 steps: {busy} [{card}]")

    te = out["test_index"][:6]
    circs = [Circuit.from_dict(entries[i].circuit) for i in te]
    obs = [decode_observable(entries[i].observable[0], 4) for i in te]
    pad_n, pad_e = out["pad_nodes"], out["pad_edges"]
    ngem_est = ngem(NoisyEstimator, out["model"], dev, skip_transpile=True,
                    pad_nodes=pad_n, pad_edges=pad_e, device=cuda)(
        dev, device=cuda)
    noisy_est = NoisyEstimator(dev, device=cuda)
    noisy_est.run(circs, obs).result()
    ngem_s = min(sync_s(lambda: ngem_est.run(circs, obs).result())[0]
                 for _ in range(3))
    plain_s = min(sync_s(lambda: noisy_est.run(circs, obs).result())[0]
                  for _ in range(3))
    res = ngem_est.run(circs, obs).result()
    rows = [ExpValueEntry(circuit_to_graph_data_json(c, props, True, True),
                          encode_pauli_sum_op(o), 0.0,
                          [m["original_value"]], c.depth()).to_arrays(
        pad_n, pad_e) for c, o, m in zip(circs, obs, res.metadata)]
    data = {k: np.stack([r[k] for r in rows]) for k in rows[0] if k != "y"}
    want = predict(out["model"], None, gnn_inputs, data)[:, 0]
    dataset_noisy = np.array([entries[i].noisy_exp_values[0] for i in te])
    orig = np.array([m["original_value"] for m in res.metadata])
    err = float(np.abs(res.values - want).max())
    print(f"ngem(NoisyEstimator) on 6 test circuits: vs predict on the "
          f"processor's graphs max|Δ|={err:.3e}; its noisy values vs the "
          f"dataset's {np.abs(orig - dataset_noisy).max():.3e}")
    print(f"ngem(NoisyEstimator).run on 6 circuits: {ngem_s * 1e3:.1f} ms "
          f"= {ngem_s / 6 * 1e3:.2f} ms a value; the NoisyEstimator alone "
          f"{plain_s * 1e3:.1f} ms (best of 3, host clock) [{card}]")
    require(err <= 1e-5, f"ngem disagrees with predict: {err}")
    launches = read_launches()
    require(not any(launches.values()), f"a kernel ran: {launches}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    print(f"phase 16 wall time {time.perf_counter() - t0:.1f} s; peak device "
          f"memory {peak:.1f} MiB (torch.cuda.max_memory_allocated) [{card}]")


def kicked_wide_phase(card, cuda):
    """Phase 17: KickedIsingEngine above K1's width (K3 at nq 14, K4 at nq
    20) against the plain path, and zne_sweep_ising at its defaults."""
    import numpy as np
    import torch

    from mlqem_tpu_torch import (KickedIsingEngine, configurable_device,
                                 zne_sweep_ising)

    t0 = time.perf_counter()
    steps = 4
    for nq, kernel, per_step in ((14, "fused_trotter_step", 1),
                                 (ZNE_NQ, "wht_planes", 2)):
        dev = configurable_device(nq, seed=0)
        J = np.random.default_rng(nq).uniform(0.05, 0.6, size=WIDE_J
                                              ).astype(np.float32)
        out, counts = {}, {}
        for use_kernel in (None, False):
            eng = KickedIsingEngine(dev, nq=nq, steps=steps, dt=DT,
                                    n_traj=WIDE_TRAJ, shots=None,
                                    device=cuda, use_kernel=use_kernel)
            reset_launches()
            out[use_kernel] = eng.generate(J, seed=5)
            torch.cuda.synchronize()
            counts[use_kernel] = read_launches()
            del eng
        err = max(float(np.abs(a - b).max())
                  for a, b in zip(out[None], out[False]))
        want = {k: 0 for k in counts[None]}
        want[kernel] = 2 * steps * per_step     # noisy and ideal arms
        print(f"KickedIsingEngine nq={nq} ({WIDE_J} circuits x {WIDE_TRAJ} "
              f"trajectories, {steps} steps, shots=None): card path vs plain "
              f"path on the same draws max|Δ|={err:.3e}; launches "
              f"{counts[None]} (plain path {counts[False]})")
        require(err <= TOL, f"nq={nq}: card path disagrees: {err}")
        require(counts[None] == want, f"nq={nq}: expected {want}")
        require(not any(counts[False].values()),
                f"nq={nq}: the plain path launched {counts[False]}")
        torch.cuda.empty_cache()

    dev = configurable_device(ZNE_NQ, seed=0)
    J_values = np.linspace(0.05, 0.6, ZNE_J).astype(np.float32)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    secs, sweep = sync_s(lambda: zne_sweep_ising(
        dev, nq=ZNE_NQ, steps=4, J_values=J_values, n_traj=ZNE_TRAJ,
        shots=SHOTS, device=cuda))
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"zne_sweep_ising (nq {ZNE_NQ}, 4 steps, {ZNE_J} J values, "
          f"{ZNE_TRAJ} trajectories, {SHOTS} shots, nf (1, 3)): {secs:.2f} s;"
          f" peak {peak:.2f} GiB; launches {counts}; RMSE noisy "
          f"{sweep['rmse_noisy']:.5f}, ZNE {sweep['rmse_zne']:.5f} [{card}]")
    want = {k: 0 for k in counts}
    want["wht_planes"] = 2 * 2 * 4 * 2        # engines x arms x steps x 2
    require(counts == want, f"zne sweep: expected launches {want}")
    for k in ("ideal", "noisy", "zne"):
        require(sweep[k].shape == (ZNE_J, ZNE_NQ)
                and bool(np.isfinite(sweep[k]).all()),
                f"zne sweep {k}: shape {sweep[k].shape} or not finite")
    pick = np.linspace(0, ZNE_J - 1, 4).astype(int)
    with ThreadPoolExecutor(4) as pool:
        exact = np.concatenate(list(pool.map(
            lambda j: exact_ideal_z(J_values[j:j + 1], ZNE_NQ, 4, DT),
            pick)))
    err = float(np.abs(sweep["ideal"][pick] - exact).max())
    print(f"zne sweep ideal labels vs complex128 statevector (J "
          f"{J_values[pick].round(4).tolist()}): max|Δ|={err:.3e}")
    require(err <= TOL, f"zne sweep ideal labels wrong: {err}")
    require(sweep["rmse_noisy"] > 1e-3, "noise had no effect")
    # the stages of one of the sweep's engine batches (nf = 1)
    eng = KickedIsingEngine(dev, nq=ZNE_NQ, steps=4, dt=DT, n_traj=ZNE_TRAJ,
                            shots=SHOTS, device=cuda)
    Jt = torch.as_tensor(J_values, device=cuda)
    split = stage_split(lambda gen, mark: eng.run(Jt, gen, mark=mark), cuda)
    print(f"zne sweep, one engine batch ({ZNE_J * ZNE_TRAJ} rows x 2^"
          f"{ZNE_NQ}), stages (median of 3, synchronized): (b) frame pass "
          f"{split['frame']:.1f} ms, (c) evolution {split['evolve']:.1f} ms,"
          f" (d) readout + <Z> + flip + shots {split['readout']:.1f} ms, "
          f"(c') ideal arm {split['ideal']:.1f} ms [{card}]")
    del eng
    print(f"phase 17 wall time {time.perf_counter() - t0:.1f} s [{card}]")


def workflow_phase(card, cuda):
    """Phase 18: the dataset families card vs CPU, demo2_ising_4q,
    random_circuit_dataset + model_comparison, train_gnn_mbl."""
    import numpy as np
    import torch

    from mlqem_tpu_torch import (configurable_device, demo2_ising_4q,
                                 get_device, ising_dataset, mbl_dataset,
                                 model_comparison, random_circuit_dataset,
                                 tiling_dataset, train_gnn_mbl)

    lima = get_device("fake_lima")
    dev10 = configurable_device(10, seed=0)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    families = {
        "ising (init prefix, lowered, routed)": lambda d: ising_dataset(
            lima, num_circuits=6, steps_range=(1, 6), shots=None,
            init_prefix=True, lower=True, route=True, seed=3, device=d),
        "mbl (bond 1-2 cut)": lambda d: mbl_dataset(
            lima, num_circuits=6, shots=None, broken_connections=[(1, 2)],
            seed=2, device=d),
        "tiling (3 in 5)": lambda d: tiling_dataset(
            lima, 3, 5, num_circuits=6, shots=None, seed=5, device=d),
        "random (10 qubits)": lambda d: random_circuit_dataset(
            dev10, 10, RC_DEPTH, num_circuits=6, shots=None, seed=6,
            device=d),
    }
    for name, build in families.items():
        card_ds, cpu_ds = build(cuda), build("cpu")
        err = max(float(np.abs(card_ds.ideal - cpu_ds.ideal).max()),
                  float(np.abs(card_ds.noisy - cpu_ds.noisy).max()))
        print(f"{name} labels, 6 circuits, shots=None: card vs CPU "
              f"max|Δ|={err:.3e}; mean |noisy - ideal| "
              f"{float(np.abs(card_ds.noisy - card_ds.ideal).mean()):.4f}")
        require(err <= TOL, f"{name} labels: card vs CPU {err}")
        require([c.to_dict() for c in card_ds.circuits]
                == [c.to_dict() for c in cpu_ds.circuits],
                f"{name}: the circuits differ")

    secs, d2 = sync_s(lambda: demo2_ising_4q(lima, device=cuda))
    print(f"demo2_ising_4q (fake_lima, 10 steps, 120 training circuits, "
          f"10,000 shots, RF 300): {secs:.2f} s; RMSE noisy "
          f"{d2['rmse_noisy']:.5f}, mitigated {d2['rmse_mitigated']:.5f}; "
          f"L2 per step noisy {np.round(d2['l2_per_step_noisy'], 4).tolist()}"
          f" [{card}]")
    require(np.isfinite([d2["rmse_noisy"], d2["rmse_mitigated"]]).all()
            and len(d2["steps"]) == 11, "demo2's output")

    ds_s, ds = sync_s(lambda: random_circuit_dataset(
        dev10, 10, RC_DEPTH, num_circuits=RC_CIRCUITS, device=cuda))
    mc_s, table = sync_s(lambda: model_comparison(
        ds, dev10, mlp_epochs=MC_MLP_EPOCHS, gnn_epochs=MC_GNN_EPOCHS,
        device=cuda))
    print(f"random_circuit_dataset(configurable_device(10), depth <= "
          f"{RC_DEPTH}, {RC_CIRCUITS} circuits, 10,000 shots): {ds_s:.2f} s; "
          f"model_comparison (MLP1 {MC_MLP_EPOCHS} of 150 epochs, GNN "
          f"{MC_GNN_EPOCHS} of 400: cut) {mc_s:.2f} s; RMSE noisy "
          f"{table['ols']['rmse_noisy']:.5f}; mitigated "
          + ", ".join(f"{k} {v['rmse_mitigated']:.5f}"
                      for k, v in table.items()) + f" [{card}]")
    for k, v in table.items():
        require(np.isfinite([v["rmse_noisy"], v["rmse_mitigated"]]).all(),
                f"model_comparison {k} is not finite")

    data_s, _ = sync_s(lambda: mbl_dataset(lima, num_qubits=4,
                                           num_circuits=600, shots=None,
                                           seed=0, device=cuda))
    secs, mbl = sync_s(lambda: train_gnn_mbl(lima, num_epochs=MBL_EPOCHS,
                                             device=cuda))
    hist = mbl["history"]
    print(f"train_gnn_mbl (fake_lima, 4 qubits, 600 MBL circuits, "
          f"{MBL_EPOCHS} of 200 epochs: cut): dataset {data_s:.2f} s; "
          f"{secs:.2f} s in all = ~{(secs - data_s) / MBL_EPOCHS:.3f} s per "
          f"epoch; val loss {hist['val_loss'][0]:.5f} -> "
          f"{min(hist['val_loss']):.5f}; RMSE noisy {mbl['rmse_noisy']:.5f},"
          f" mitigated {mbl['rmse_mitigated']:.5f} [{card}]")
    require(bool(np.isfinite(hist["train_loss"]).all())
            and min(hist["val_loss"]) < hist["val_loss"][0],
            "train_gnn_mbl's validation loss never fell")
    launches = read_launches()
    require(not any(launches.values()), f"a kernel ran: {launches}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"phase 18 wall time {time.perf_counter() - t0:.1f} s; peak "
          f"{peak:.2f} GiB [{card}]")


def demo1_phase(card, cuda):
    """Phase 19: demo1_zne_mimic_100q at 100 qubits, 10 steps, w=21 through
    K4, with cut circuit and realization counts."""
    import numpy as np
    import torch

    from mlqem_tpu_torch import (LightconeIsing, configurable_device,
                                 demo1_zne_mimic_100q)
    from mlqem_tpu_torch.workflows.demos import DEMO1_CALIBRATED_SCALE

    dev = configurable_device(LC_NQ, seed=1)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    secs, out = sync_s(lambda: demo1_zne_mimic_100q(
        dev, nq=LC_NQ, num_steps=D1_STEPS, num_circ_per_step=D1_CIRCUITS,
        train_per_step=D1_TRAIN, num_twirls=D1_TWIRLS,
        num_twirls_amp=D1_TWIRLS_AMP, shots=D1_SHOTS,
        noise_scale=DEMO1_CALIBRATED_SCALE, device=cuda))
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    Q = len(LC_QUBITS)
    print(f"demo1_zne_mimic_100q ({LC_NQ} qubits, {D1_STEPS} steps, w="
          f"{2 * D1_STEPS + 1}, scale {DEMO1_CALIBRATED_SCALE}; cut: "
          f"{D1_CIRCUITS} circuits a step (of 50), {D1_TRAIN} train (of 10), "
          f"{D1_TWIRLS}/{D1_TWIRLS_AMP} realizations (of 1024/256), "
          f"{D1_SHOTS} shots each): {secs:.2f} s; peak {peak:.2f} GiB; "
          f"launches {counts} [{card}]")
    # 5 windows x steps x 2 K4 calls x (nf1 + ideal, nf3; J00 alike)
    want = {k: 0 for k in counts}
    want["wht_planes"] = Q * D1_STEPS * 2 * 6
    require(counts == want, f"demo1: expected launches {want}")
    print("demo1 RMSE vs ZNE: noisy {:.5f}, mimic {:.5f}; vs ideal: noisy "
          "{:.5f}, ZNE {:.5f}, mimic {:.5f}".format(
              out["rmse_noisy_vs_zne"], out["rmse_mimic_vs_zne"],
              out["rmse_noisy"], out["rmse_zne"], out["rmse_mimic"]))
    rows = out["rows"]
    require(len(rows) == D1_STEPS * D1_CIRCUITS, "demo1 rows")
    for k in ("noisy", "zne", "ideal"):
        require(bool(np.isfinite(np.stack([r[k] for r in rows])).all()),
                f"demo1 {k} rows are not finite")
    ideal = np.stack([r["ideal"] for r in rows]).reshape(
        D1_STEPS, D1_CIRCUITS, Q).transpose(1, 0, 2)
    J = np.asarray([r["J"] for r in rows[:D1_CIRCUITS]], np.float32)
    lc = LightconeIsing(dev, nq=LC_NQ, steps=D1_STEPS, device=cuda, dt=LC_DT,
                        h=LC_H, n_traj=1, shots=None, noise=False,
                        readout=False)
    want_ideal = lc.ideal_stepwise(J[1:], qubits=LC_QUBITS)
    err = float(np.abs(ideal[1:] - want_ideal).max())
    cliff = np.cos(np.arange(1, D1_STEPS + 1) * np.pi / 2.0)[:, None]
    err0 = float(np.abs(ideal[0] - cliff).max())
    print(f"demo1 ideal rows vs LightconeIsing.ideal_stepwise: max|Δ|="
          f"{err:.3e}; J00 row vs cos(s·π/2): max|Δ|={err0:.3e}")
    require(J[0] == 0.0 and err <= 1e-6, f"demo1 ideal rows: {err}")
    require(err0 <= TOL, f"demo1 J00 row: {err0}")


def phase_begin():
    """Synchronize, reset the peak-memory counter and start the clock."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return time.perf_counter()


def phase_end(name, t0, card):
    import torch

    torch.cuda.synchronize()
    print(f"phase {name} wall time {time.perf_counter() - t0:.1f} s; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
          f"GiB [{card}]")


def pauli_prop_phase(card, cuda):
    """Phase 20: the sparse Pauli-propagation engine: card vs CPU (20a),
    the shipped K=131072 audit recomputed with its K-doubling audit (20b),
    the light-cone cross-check on its own recomputed reference (20c) and
    demo1 through the engine (20d)."""
    import numpy as np

    from mlqem_tpu_torch import (PauliPropagatorIsing, configurable_device,
                                 demo1_zne_mimic_100q, lightcone_crosscheck,
                                 truncation_convergence)
    from mlqem_tpu_torch.workflows.demos import DEMO1_CALIBRATED_SCALE

    arms = (("ideal", False, 1), ("nf1", True, 1), ("nf3", True, 3))

    # -- 20a. the engine on the card vs the CPU ------------------------------
    t0 = phase_begin()
    dev40 = configurable_device(PP_NQ, seed=1)
    J = np.array([0.05, 0.3, 0.55], np.float32)
    for K in (PP_K_EXACT, PP_K_TRUNC):
        for arm, noisy, nf in arms:
            (v, e), (cv, ce) = (PauliPropagatorIsing(
                dev40, nq=PP_NQ, steps=PP_STEPS, dt=LC_DT, h=LC_H,
                max_terms=K, noise=noisy, device=d).generate_stepwise(
                    J, nf, PP_QUBITS) for d in (cuda, "cpu"))
            err = float(np.abs(v - cv).max())
            derr = float(np.abs(e - ce).max())
            print(f"PauliPropagatorIsing nq={PP_NQ} (qubits {PP_QUBITS}), "
                  f"{PP_STEPS} steps, K={K}, {arm}: card vs CPU max|Δ| "
                  f"values {err:.3e}, discarded weight {derr:.3e}; "
                  f"discarded {float(e.max()):.4e} (CPU {float(ce.max()):.4e})")
            if K == PP_K_EXACT:
                require(float(e.max()) == float(ce.max()) == 0.0,
                        f"20a: K={K} discarded terms")
                require(err <= 1e-6, f"20a: card vs CPU {err} at K={K}")
            else:
                require(float(e.max()) > 0.0, f"20a: K={K} cut nothing")
                require(max(err, derr) <= PP_TRUNC_TOL,
                        f"20a: card vs CPU {err}, {derr} at K={K}")
    phase_end("20a", t0, card)

    # -- 20b. the shipped K=131072 audit, recomputed -------------------------
    results = os.path.join(ROOT, "docs", "demos", "results")
    audit = np.load(os.path.join(results, "audit_values_tpu.npz"))
    with open(os.path.join(results, "truncation_audit_tpu.json")) as f:
        shipped = json.load(f)
    t0 = phase_begin()
    dev = configurable_device(LC_NQ, seed=int(audit["device_seed"]))
    Ja = audit["J_values"].astype(np.float32)
    qa = [int(q) for q in audit["qubits"]]
    phys = dict(nq=LC_NQ, dt=float(audit["dt"]), h=float(audit["h"]))
    K = int(audit["K"])
    require(K == AUDIT_KS[-1] and tuple(shipped["K_values"]) == AUDIT_KS,
            "the shipped audit's K values changed")
    for arm, noisy, nf in arms:
        eng = PauliPropagatorIsing(dev, steps=LC_STEPS, max_terms=K,
                                   noise=noisy, device=cuda, **phys)
        secs, (v, e) = sync_s(lambda: eng.generate_stepwise(Ja, nf, qa))
        diff = np.abs(v - audit[arm]).max(axis=(0, 2))
        print(f"audit recomputed ({LC_NQ}q, {LC_STEPS} steps, K={K}), "
              f"{arm}: {secs:.2f} s; max|Δ| vs audit_values_tpu.npz per step "
              f"{[float(f'{x:.3e}') for x in diff]}; discarded weight at "
              f"step 10 {float(e[:, -1].max()):.4e} [{card}]")
        require(bool(np.isfinite(v).all()), f"20b {arm}: not finite")
        require(float(diff[:AUDIT_GATED].max()) <= AUDIT_TOL,
                f"20b {arm}: steps 1-{AUDIT_GATED} differ from the shipped "
                f"values by {float(diff[:AUDIT_GATED].max())}")
    secs, conv = sync_s(lambda: truncation_convergence(
        dev, num_steps=LC_STEPS, J_values=tuple(Ja.tolist()), qubits=qa,
        K_values=AUDIT_KS, noise_factors=(0, 1, 3), tol=AUDIT_TOL,
        device=cuda, **phys))
    print(f"truncation_convergence K={AUDIT_KS}: {secs:.2f} s; validated "
          f"depth {conv['validated_depth']} (shipped "
          f"{shipped['validated_depth']}) [{card}]")
    for arm in ("ideal", "nf1", "nf3"):
        top = conv["arms"][arm]["per_step_drift"][-1]
        was = shipped["arms"][arm]["per_step_drift"][-1]
        print(f"  {arm} top-pair drift per step "
              f"{[float(f'{x:.3e}') for x in top]}; shipped "
              f"{[float(f'{x:.3e}') for x in was]}")
        require(max(top[:DRIFT_GATED]) <= AUDIT_TOL,
                f"20b {arm}: top-pair drift {max(top[:DRIFT_GATED])} at "
                f"steps 1-{DRIFT_GATED}")
    phase_end("20b", t0, card)

    # -- 20c. the cross-check on its own reference ---------------------------
    t0 = phase_begin()
    reset_launches()
    secs, xck = sync_s(lambda: lightcone_crosscheck(
        dev, steps=6, J_values=tuple(Ja.tolist()), qubits=qa, max_terms=K,
        n_traj=XCK_TRAJ, reference=None, seed=1, device=cuda, **phys))
    counts = read_launches()
    ref = RESULTS["crosscheck"]
    print(f"cross-check on its recomputed reference (K={K}): ideal max|Δ|="
          f"{xck['ideal_max_diff']:.3e} (phase 10, shipped values: "
          f"{ref['ideal_max_diff']:.3e}), noisy {xck['noisy_max_diff']} "
          f"(phase 10: {ref['noisy_max_diff']}), passed={xck['passed']}; "
          f"launches {counts}; {secs:.2f} s [{card}]")
    require(xck["passed"] and xck["config"]["reference"] == "recomputed",
            "20c: the cross-check failed on its recomputed reference")
    require(counts["fused_trotter_step"] == 90 and counts["wht_planes"] == 0,
            f"20c: expected 90 K3 and 0 K4 launches, got {counts}")
    phase_end("20c", t0, card)

    # -- 20d. demo1 through the Pauli-propagation engine ---------------------
    t0 = phase_begin()
    reset_launches()
    secs, d1 = sync_s(lambda: demo1_zne_mimic_100q(
        dev, nq=LC_NQ, num_steps=D1_STEPS, num_circ_per_step=D1_CIRCUITS,
        train_per_step=D1_TRAIN, noise_scale=DEMO1_CALIBRATED_SCALE,
        engine="pauli_prop", device=cuda))
    counts = read_launches()
    print(f"demo1_zne_mimic_100q(engine='pauli_prop') ({LC_NQ} qubits, "
          f"{D1_STEPS} steps, max_terms 8192, 10,000 shots x 5 twirls; cut: "
          f"{D1_CIRCUITS} circuits a step (of 50), {D1_TRAIN} train (of "
          f"10)): {secs:.2f} s; max discarded weight "
          f"{d1['max_truncation_discard']:.4e}; launches {counts} [{card}]")
    print("demo1 (pauli_prop) RMSE vs ZNE: noisy {:.5f}, mimic {:.5f}; vs "
          "ideal: noisy {:.5f}, ZNE {:.5f}, mimic {:.5f}".format(
              d1["rmse_noisy_vs_zne"], d1["rmse_mimic_vs_zne"],
              d1["rmse_noisy"], d1["rmse_zne"], d1["rmse_mimic"]))
    rows = d1["rows"]
    require(len(rows) == D1_STEPS * D1_CIRCUITS, "20d: demo1 rows")
    for k in ("noisy", "zne", "ideal"):
        require(bool(np.isfinite(np.stack([r[k] for r in rows])).all()),
                f"20d: demo1 {k} rows are not finite")
    j0 = sorted((r for r in rows if r["J"] == 0.0), key=lambda r: r["step"])
    err0 = max(float(np.abs(r["ideal"] - np.cos(r["step"] * np.pi / 2)
                            ).max()) for r in j0)
    print(f"demo1 (pauli_prop) J00 row vs cos(s·π/2): max|Δ|={err0:.3e}")
    require(len(j0) == D1_STEPS and err0 <= TOL, f"20d: J00 row {err0}")
    phase_end("20d", t0, card)


def stabilizer_phase(card, cuda):
    """Phase 21: the stabilizer tableau and the workflows above it: the
    Clifford scalability sweep card vs CPU (21a), multi-qubit RB (21b)
    and the faithful single-Ising parity run (21c)."""
    import numpy as np

    from mlqem_tpu_torch import (PUBLISHED, scalability_sweep,
                                 single_ising_parity, tensorize)
    from mlqem_tpu_torch.data.generators import generate_rb_circuit
    from mlqem_tpu_torch.ops.statevector import statevector

    # -- 21a. the scalability sweep at its defaults --------------------------
    t0 = phase_begin()
    rows = scalability_sweep(device=cuda)
    cpu_rows = scalability_sweep(device="cpu")
    for r, c in zip(rows, cpu_rows):
        print(f"scalability_sweep {r['n_qubits']} qubits, depth "
              f"{r['depth']}, {r['circuits']} circuits: card "
              f"{r['circuits_per_sec']:.1f} circuits/s (CPU "
              f"{c['circuits_per_sec']:.1f}); mean |<Z_0>| "
              f"{r['mean_abs_label']:.3f} [{card}]")
        require(r["labels"] == c["labels"] and r["n_qubits"] == c["n_qubits"],
                f"21a: card labels differ from the CPU's at "
                f"{r['n_qubits']} qubits, depth {r['depth']}")
    require(len(rows) == 18, f"21a: {len(rows)} rows")
    phase_end("21a", t0, card)

    # -- 21b. multi-qubit randomized benchmarking ----------------------------
    t0 = phase_begin()
    for nq, length, seed in ((2, 5, 0), (2, 20, 1), (3, 5, 2), (3, 20, 3)):
        qc = generate_rb_circuit(nq, length, seed=seed)
        amp0 = float(statevector(tensorize(qc), device=cuda)[0].abs())
        print(f"generate_rb_circuit({nq}, {length}, seed={seed}): "
              f"{len(qc.ops)} ops; |<0|U|0>| = {amp0:.7f}")
        require(abs(amp0 - 1.0) <= TOL, f"21b: RB at {nq} qubits: {amp0}")
    phase_end("21b", t0, card)

    # -- 21c. the faithful single-Ising parity run ---------------------------
    t0 = phase_begin()
    secs, par = sync_s(lambda: single_ising_parity(
        "incoherent", protocol="faithful", seed=0,
        mlp_epochs=PARITY_MLP_EPOCHS, gnn_epochs=PARITY_GNN_EPOCHS,
        arms=PARITY_ARMS, device=cuda))
    pub = PUBLISHED["incoherent"]
    print(f"single_ising_parity('incoherent', protocol='faithful', seed 0; "
          f"{par['num_train']} train circuits, 30-step test sweep, 10,000 "
          f"shots, ZNE with {par['num_twirls']} twirls, noise scale "
          f"{par['noise_scale']}; cut: MLP {PARITY_MLP_EPOCHS} of 200 "
          f"epochs, GNN {PARITY_GNN_EPOCHS} of 400 on "
          f"{par['gnn_train_count']} circuits, the random-forest arm left "
          f"out (4 host fits of RF(300) on 4500 rows)): {secs:.2f} s [{card}]")
    for k, v in par["ours"].items():
        print(f"  {k}: RMSE {v:.5f} (published {pub.get(k, '-')})")
    noisy = par["ours"]["noisy"]
    require(abs(noisy - pub["noisy"]) <= 0.1 * pub["noisy"],
            f"21c: noisy RMSE {noisy} is not within 10% of {pub['noisy']}")
    require(all(np.isfinite(v) for v in par["ours"].values()),
            "21c: an arm is not finite")
    phase_end("21c", t0, card)


def wide_frame_phase(card, cuda):
    """Phase 22: IsingLabelPipeline at nq 14: the engine each method takes
    ("frame" and "trajectory" K2 on the card, the gather engine by its
    name), card vs CPU on shared draws, one K2 launch for K2's engine (the
    chip tier); K2 against its plain version at the timed batch's shape;
    at nq 13 the frame method still runs K2; K2's times at each tier's
    widths (:func:`k2_tier_times`)."""
    import numpy as np
    import torch

    import mlqem_tpu_torch.ops.kernels.frame_evolve as kfe
    from mlqem_tpu_torch import IsingLabelPipeline, configurable_device
    from mlqem_tpu_torch.ops.frame_trajectory import frame_theta_eff

    t0 = phase_begin()
    nq, B, T = WIDE_FRAME_NQ, WIDE_FRAME_B, WIDE_FRAME_T
    dev = configurable_device(nq, seed=0)
    rng = np.random.default_rng(22)
    J = rng.uniform(0.05, 0.6, size=B).astype(np.float32)
    # (engine on the card, on the CPU): "trajectory" takes K2 on the card at
    # every width, as the JAX package does on its accelerator; the gather
    # engine by its name
    gather = "trajectory_gather"
    engines = {"frame": ("k2", "k2"), "trajectory": ("k2", gather),
               gather: (gather, gather)}
    for method, (engine, cpu_engine) in engines.items():
        out, draws = {}, None
        for d in (cuda, "cpu"):
            pipe = IsingLabelPipeline(dev, nq=nq, steps=2, device=d,
                                      shots=None, method=method, n_traj=T)
            want = engine if d is cuda else cpu_engine
            require(pipe.noisy_engine == want,
                    f"22: method={method!r} at nq={nq} on {d} took "
                    f"{pipe.noisy_engine!r}, not {want!r}")
            if draws is None:
                # mostly identity, plus a share of uniform Paulis on every op
                draws = rng.integers(0, 16, size=(
                    B, T, pipe.ct_struct.max_ops)).astype(np.int32)
                draws[rng.random(draws.shape) < 0.7] = 0
            shared = torch.as_tensor(draws, device=pipe.device)
            pipe.sample_draws = lambda batch, gen, _d=shared: _d
            reset_launches()
            out[str(d)] = pipe.generate(J, seed=0)
            torch.cuda.synchronize()
            launches = read_launches()
            k2 = int(pipe.noisy_engine == "k2" and pipe.device.type == "cuda")
            print(f"  {method!r} on {d}: launches {launches}")
            require(launches == {**{k: 0 for k in launches},
                                 "evolve_frame_marginals": k2},
                    f"22: {method} on {d} launched {launches}")
        err = max(float(np.abs(a - b).max())
                  for a, b in zip(out[str(cuda)], out["cpu"]))
        print(f"IsingLabelPipeline(nq={nq}, steps=2, method={method!r}) -> "
              f"engine {engine!r}: {B} circuits x {T} trajectories, "
              f"shots=None, shared draws: card vs CPU max|Δ| = {err:.3e}; "
              f"mean |noisy - ideal| "
              f"{float(np.abs(out['cpu'][1] - out['cpu'][0]).mean()):.4f}")
        require(err <= TOL, f"22: {method} card vs CPU {err}")
        if method == "trajectory":
            continue                        # the same engine as "frame"
        pipe = IsingLabelPipeline(dev, nq=nq, steps=2, device=cuda,
                                  method=method, n_traj=N_TRAJ)
        Jt = rng.uniform(0.05, 0.6, size=WIDE_FRAME_TIME_B)
        pipe.generate(Jt, seed=1)
        secs, _ = sync_s(lambda: pipe.generate(Jt, seed=2))
        print(f"  engine {engine!r} at nq={nq}, {WIDE_FRAME_TIME_B} circuits "
              f"x {N_TRAJ} trajectories, {SHOTS} shots: {secs * 1e3:.1f} ms "
              f"a batch = {WIDE_FRAME_TIME_B * 60 / secs:.0f} pairs/min "
              f"[{card}]")
        if engine != "k2":
            continue
        # K2's chip tier at this batch's shape, against its plain version
        gen = torch.Generator(device=cuda)
        gen.manual_seed(3)
        ct = pipe.template.bind(torch.as_tensor(
            Jt[:, None], dtype=torch.float32, device=cuda))
        theta, _, plan = frame_theta_eff(
            pipe.ct_struct, ct.params, pipe.sample_draws(len(Jt), gen))
        got = kfe.evolve_frame_marginals(theta, plan, nq)
        want = kfe.evolve_frame_marginals_reference(theta, plan, nq)
        torch.cuda.synchronize()
        k2_err = (got - want).abs().max().item()
        del got, want
        require(k2_err <= K2_TOL, f"22: K2 at nq={nq} disagrees with its "
                f"plain version: {k2_err}")
        k_ms, p_ms, kernel_ms, plain_ms = time_kernel_and_plain(
            lambda: kfe.evolve_frame_marginals(theta, plan, nq),
            lambda: kfe.evolve_frame_marginals_reference(theta, plan, nq), 1)
        fused = kfe.fuse_plan(plan)
        rows = theta.shape[0]
        k2_bound = bound(4 * theta.numel() + 4 * rows * nq + 16 * len(fused),
                         rows * plan_flops(fused, nq))
        print(f"  evolve_frame_marginals nq={nq} ops={len(plan)} (run as "
              f"{len(fused)}){k2_tier(plan, nq, theta.shape[1])} "
              f"rows={rows}: max|Δ|={k2_err:.3e}; kernel "
              f"{k_ms:.3f} ms (runs {[round(x, 3) for x in kernel_ms]}), "
              f"plain PyTorch {p_ms:.3f} ms (runs "
              f"{[round(x, 3) for x in plain_ms]}); bound "
              f"{k2_bound[0]:.3f} ms ({k2_bound[1]}) [{card}]")
        del theta, pipe
        torch.cuda.empty_cache()
    pipe = IsingLabelPipeline(configurable_device(13, seed=0), nq=13, steps=2,
                              device=cuda, method="frame", n_traj=T)
    reset_launches()
    pipe.generate(J, seed=0)
    torch.cuda.synchronize()
    k2 = read_launches()["evolve_frame_marginals"]
    print(f"IsingLabelPipeline(nq=13, method='frame') -> engine "
          f"{pipe.noisy_engine!r}: {k2} K2 launch")
    require(pipe.noisy_engine == "k2" and k2 == 1, "22: nq 13 left K2")
    k2_tier_times(card, cuda)
    phase_end("22", t0, card)


def vqe_dataset_phase(card, cuda):
    """Phase 23: vqe_dataset at the reference's size, and a 200-circuit
    slice card vs CPU."""
    import numpy as np

    from mlqem_tpu_torch import get_device, vqe_dataset
    from mlqem_tpu_torch.utils.profiling import StageTimer

    lima = get_device("fake_lima")
    t0 = phase_begin()
    timer = StageTimer()
    reset_launches()
    secs, data = sync_s(lambda: vqe_dataset(
        lima, samples_per_pauli=VQE_SAMPLES, shots=VQE_SHOTS, device=cuda,
        timer=timer))
    n = len(data["circuits"])
    print(f"vqe_dataset(fake_lima, TwoLocal(ry, cz, reps 3, full), 5 Paulis "
          f"x {VQE_SAMPLES} = {n} circuits, {VQE_SHOTS} shots): {secs:.2f} s; "
          f"estimators {timer.totals['estimators']:.2f} s, host transpile + "
          f"encode {timer.totals['encode']:.2f} s "
          f"({timer.totals['encode'] / n * 1e3:.3f} ms a circuit); X "
          f"{data['X'].shape}; mean |noisy - ideal| "
          f"{float(np.abs(data['noisy'] - data['ideal']).mean()):.4f} [{card}]")
    require(n == 5 * VQE_SAMPLES and data["X"].shape[0] == n
            and bool(np.isfinite(data["X"]).all()), "23: the dataset")
    require(not any(read_launches().values()),
            f"23: a kernel ran: {read_launches()}")
    phase_end("23 (reference size)", t0, card)
    t0 = phase_begin()
    check = [vqe_dataset(lima, samples_per_pauli=VQE_CHECK_SAMPLES,
                         shots=None, device=d) for d in (cuda, "cpu")]
    err = max(float(np.abs(check[0][k] - check[1][k]).max())
              for k in ("ideal", "noisy", "X"))
    print(f"vqe_dataset, {5 * VQE_CHECK_SAMPLES} circuits, shots=None: card "
          f"vs CPU max|Δ| (ideal, noisy, X) = {err:.3e}")
    require(err <= TOL, f"23: card vs CPU {err}")
    phase_end("23 (card vs CPU)", t0, card)


def h2_curve_phase(card, cuda):
    """Phase 24: h2_dissociation_curve at its defaults on PUBLISHED_H2's
    four bond lengths, the busy share of one mitigated energy evaluation,
    and one bond card vs CPU."""
    import numpy as np

    from mlqem_tpu_torch import (PUBLISHED_H2, VQE, NoisyEstimator,
                                 RandomForestRegressor, get_device, learning,
                                 load_h2_problems, train_vqe_processor,
                                 vqe_dataset, vqe_mitigation_study)
    from mlqem_tpu_torch.circuits.families import two_local_ansatz
    from mlqem_tpu_torch.mitigation.learning import ModelProcessor
    from mlqem_tpu_torch.utils.profiling import StageTimer

    lima = get_device("fake_lima")
    t0 = phase_begin()
    reset_launches()
    # h2_dissociation_curve at its defaults, step by step as it runs them,
    # to time each step and keep the forest
    timer = StageTimer()
    data_s, data = sync_s(lambda: vqe_dataset(
        lima, num_qubits=2, samples_per_pauli=80, shots=VQE_SHOTS,
        device=cuda, timer=timer))
    fit_s, (processor, stats) = sync_s(lambda: train_vqe_processor(
        lima, data, device=cuda))
    problems = load_h2_problems()
    rows, bond_s = [], []
    for length, fci, ham in [problems[i] for i in H2_BONDS]:
        secs, res = sync_s(lambda: vqe_mitigation_study(
            lima, ham, processor, maxiter=60, shots=VQE_SHOTS, device=cuda,
            timer=timer))
        rows.append({"bond_length": length, "fci": fci, **res})
        bond_s.append(secs)
    secs = data_s + fit_s + sum(bond_s)
    print(f"h2_dissociation_curve's steps (fake_lima, bonds {H2_BONDS}; 80 "
          f"per Pauli, RF(300), COBYLA 60, {VQE_SHOTS} shots): {secs:.2f} s "
          f"= dataset {data_s:.2f} s + forest {fit_s:.2f} s (host fit, "
          f"held-out predict) + bonds "
          f"{[round(x, 2) for x in bond_s]} s [{card}]")
    print("  stages: " + "; ".join(f"{k} {v:.2f} s" for k, v in
                                   timer.totals.items()))
    print(f"  forest on the held-out fifth: RMSE noisy "
          f"{stats['rmse_noisy']:.5f}, mitigated {stats['rmse_mitigated']:.5f}")
    for r in rows:
        i = PUBLISHED_H2["bond_lengths"].index(r["bond_length"])
        print(f"  bond {r['bond_length']} A (FCI {r['fci']:.4f}, exact "
              f"{r['exact']:.4f}): " + ", ".join(
                  f"{arm} {r[arm]:.4f} (published {PUBLISHED_H2[arm][i]})"
                  for arm in ("ideal", "noisy", "mitigated"))
              + f"; |error| noisy {r['error_noisy']:.4f}, mitigated "
              f"{r['error_mitigated']:.4f}")
    mean_noisy = float(np.mean([r["error_noisy"] for r in rows]))
    mean_mit = float(np.mean([r["error_mitigated"] for r in rows]))
    print(f"  mean |error| over {len(rows)} bonds: noisy {mean_noisy:.4f}, "
          f"mitigated {mean_mit:.4f}")
    require(mean_mit < mean_noisy, "24: mitigation did not beat the noisy "
            f"arm on average ({mean_mit} >= {mean_noisy})")
    require(not any(read_launches().values()),
            f"24: a kernel ran: {read_launches()}")

    _, _, ham = problems[H2_CHECK_BOND]
    est = learning(NoisyEstimator, processor, skip_transpile=True)(
        lima, shots=VQE_SHOTS, device=cuda)
    vqe = VQE(est, two_local_ansatz(2, reps=3), separate_observables=True)
    theta = np.random.default_rng(24).uniform(-np.pi, np.pi, 8)
    print(f"  one mitigated energy evaluation (5 terms, {VQE_SHOTS} shots): "
          + device_busy(lambda: vqe._energy(ham, theta), 5) + f" [{card}]")
    phase_end("24 (curve)", t0, card)

    t0 = phase_begin()
    rf = processor._model
    rf_cpu = RandomForestRegressor(rf.n_estimators, device="cpu").set_stacked(
        *[a.cpu().numpy() for a in rf._stacked], rf._depth)
    proc_cpu = ModelProcessor(rf_cpu, lima, skip_transpile=False)
    arms = {}
    for d, proc in ((cuda, processor), ("cpu", proc_cpu)):
        arms[str(d)] = vqe_mitigation_study(lima, ham, proc,
                                            maxiter=H2_CHECK_MAXITER,
                                            shots=None, device=d)
    err = max(abs(arms[str(cuda)][k] - arms["cpu"][k])
              for k in arms["cpu"])
    print(f"vqe_mitigation_study bond {problems[H2_CHECK_BOND][0]} "
          f"A, shots=None, COBYLA {H2_CHECK_MAXITER}: card vs CPU max|Δ| over "
          f"the arms = {err:.3e} (" + ", ".join(
              f"{k} {v:.6f}" for k, v in arms[str(cuda)].items()) + ")")
    require(err <= TOL, f"24: card vs CPU {err}")
    phase_end("24 (card vs CPU)", t0, card)


def host_modules_phase(card, cuda):
    """Phase 25: entry()'s forward card vs CPU, the native encoder library
    built here against its numpy versions, a QASM round trip."""
    import numpy as np
    import torch

    from mlqem_tpu_torch import get_device
    from mlqem_tpu_torch.circuits.families import random_circuit
    from mlqem_tpu_torch.data.encoders import encode_data
    from mlqem_tpu_torch.entry import entry
    from mlqem_tpu_torch.transpile.qasm import from_qasm, to_qasm
    from mlqem_tpu_torch.utils import native

    t0 = phase_begin()
    fn, args = entry(device=cuda)
    cpu_args = [{k: v.cpu() for k, v in args[0].items()}] + [
        a.cpu() for a in args[1:]]
    got = fn(*args)
    err = float((got.cpu() - fn(*cpu_args)).abs().max())
    ms = time_ms(lambda: fn(*args), 20)
    print(f"entry(): ExpValCircuitGraphModel3 (hidden 15) forward at B 8, N "
          f"32, F 22, K 4: card vs CPU max|Δ| = {err:.3e}; {ms:.3f} ms a "
          f"forward [{card}]")
    require(tuple(got.shape) == (8, 4) and bool(torch.isfinite(got).all())
            and err <= TOL, f"25: entry forward {err}")

    lima = get_device("fake_lima")
    lib = native.load_native()
    require(lib is not None, "25: the native encoder library did not build")
    rng = np.random.default_rng(25)
    circs = [random_circuit(4, int(rng.integers(2, 6)),
                            seed=int(rng.integers(2 ** 31)))
             for _ in range(300)]
    props = lima.properties()
    kind_index = {g: i for i, g in enumerate(sorted(props["gates_set"]))}
    flat = native.flatten_circuits(circs, kind_index)
    same = (np.array_equal(native.count_gates_batch(flat, len(kind_index)),
                           native.count_gates_batch_reference(
                               flat, len(kind_index)))
            and np.array_equal(native.angle_hist_batch(flat, 40),
                               native.angle_hist_batch_reference(flat, 40))
            and all(np.array_equal(a, b) for a, b in zip(
                native.wire_edges_batch(flat),
                native.wire_edges_batch_reference(flat))))
    vals = rng.uniform(-1, 1, (300, 4)).tolist()
    t = time.perf_counter()
    X, _ = native.fast_encode_data(circs, props, vals, vals, 4)
    fast_s = time.perf_counter() - t
    t = time.perf_counter()
    X_ref, _ = encode_data(circs, props, vals, vals, 4)
    ref_s = time.perf_counter() - t
    x_err = float(np.abs(X - X_ref).max())
    print(f"native encoders ({os.path.basename(lib._name)}): batches equal to "
          f"the numpy versions: {same}; fast_encode_data vs encode_data on "
          f"300 circuits max|Δ| = {x_err:.3e}; {fast_s * 1e3:.1f} ms vs "
          f"{ref_s * 1e3:.1f} ms on the host")
    require(same and x_err <= 1e-6, "25: native encoders disagree")

    qc = circs[0].copy()
    qc.measure_all()
    text = to_qasm(qc)
    back = from_qasm(text)
    require(to_qasm(back) == text and back.count_ops() == qc.count_ops(),
            "25: QASM round trip")
    print(f"QASM round trip: {len(text.splitlines())} lines, "
          f"{sum(qc.count_ops().values())} ops")
    phase_end("25", t0, card)


def mesh_phase(card, cuda):
    """Phase 26: both generators through ``generate(mesh=)`` on a one-rank
    NCCL mesh at their bench sizes, against the unsharded call."""
    import numpy as np
    import torch

    from mlqem_tpu_torch import (IsingLabelPipeline, KickedIsingEngine,
                                 configurable_device)
    from mlqem_tpu_torch.parallel.mesh import make_mesh

    t0 = phase_begin()
    mesh = make_mesh(device=cuda)
    print(f"mesh: {mesh} (one NCCL rank on the card; a one-rank group "
          f"started by make_mesh)")
    require(tuple(mesh.shape) == (1, 1), f"26: mesh shape {mesh.shape}")
    device_model = configurable_device(NQ, seed=0)
    rng = np.random.default_rng(26)
    cases = (
        ("kicked", BATCH, "evolve_fused", 2,
         lambda shots: KickedIsingEngine(device_model, nq=NQ, steps=STEPS,
                                         dt=DT, n_traj=N_TRAJ, shots=shots,
                                         device=cuda)),
        ("frame", FRAME_BATCH, "evolve_frame_marginals", 1,
         lambda shots: IsingLabelPipeline(device_model, nq=NQ, steps=STEPS,
                                          dt=DT, h=1.0, n_traj=N_TRAJ,
                                          method="frame", shots=shots,
                                          device=cuda)))
    for name, batch, kernel, n_launch, make in cases:
        J = rng.uniform(0.05, 0.6, size=batch).astype(np.float32)
        for shots in (None, SHOTS):
            eng = make(shots)
            want = eng.generate(J, seed=5)
            reset_launches()
            got = eng.generate(J, seed=5, mesh=mesh)
            torch.cuda.synchronize()
            launches = read_launches()
            err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
            print(f"26 {name}: {batch} circuits x {N_TRAJ} trajectories, "
                  f"shots={shots}: generate(mesh=) vs unsharded max|Δ| = "
                  f"{err:.3e}; launches on the dp path {launches}")
            require(err <= 1e-6, f"26: {name} sharded vs unsharded {err}")
            require(launches[kernel] == n_launch and sum(
                launches.values()) == n_launch,
                f"26: {name} dp path launches {launches}")
        times = {"unsharded": [], "mesh": []}
        for rep in range(4):               # unsharded, mesh, mesh, unsharded
            for key in (("unsharded", "mesh") if rep % 2 == 0
                        else ("mesh", "unsharded")):
                torch.cuda.synchronize()
                t = time.perf_counter()
                eng.generate(J, seed=6 + rep,
                             mesh=mesh if key == "mesh" else None)
                times[key].append((time.perf_counter() - t) * 1e3)
        med = {k: statistics.median(v[1:]) for k, v in times.items()}
        print(f"26 {name}: batch time with the mesh {med['mesh']:.1f} ms vs "
              f"unsharded {med['unsharded']:.1f} ms (medians after a "
              f"warm-up; runs {[round(x, 1) for x in times['mesh']]} / "
              f"{[round(x, 1) for x in times['unsharded']]} ms) [{card}]")
        del eng
        torch.cuda.empty_cache()
    phase_end("26", t0, card)
    return mesh


def _z_from_state(psi, nq):
    """⟨Z_q⟩ of a statevector, one qubit at a time (no sign table)."""
    import torch

    probs = psi.real * psi.real + psi.imag * psi.imag
    out = []
    for q in range(nq):
        p = probs.reshape(-1, 2, 2 ** q).sum(dim=(0, 2), dtype=torch.float64)
        out.append(float(p[0] - p[1]))
    return out


def sharded_sv_phase(card, cuda, mesh):
    """Phase 27: the amplitude-sharded statevector on the card's one-rank
    mesh at SV_NQ qubits against ``statevector``; on 8 gloo CPU ranks,
    ``dryrun_multichip(8)`` and sp = 2/4/8 against one rank; then
    ``dryrun_multichip(1)`` on the card."""
    import numpy as np
    import torch

    from mlqem_tpu_torch import dryrun_multichip
    from mlqem_tpu_torch.circuits.circuit import tensorize
    from mlqem_tpu_torch.circuits.families import (IsingModel, IsingOptions,
                                                   random_circuit)
    from mlqem_tpu_torch.entry import sharded_sv_runs
    from mlqem_tpu_torch.ops.sharded_sv import (sharded_statevector_fn,
                                                sharded_z_expectations)
    from mlqem_tpu_torch.ops.statevector import statevector
    from mlqem_tpu_torch.parallel.mesh import spawn

    t0 = phase_begin()
    qc = IsingModel.make_circuit(IsingOptions(nq=SV_NQ, h=1.0, J=0.3,
                                              dt=0.5, depth=2), measure=False)
    ct = tensorize(qc)
    fn = sharded_statevector_fn(qc, mesh, device=cuda)
    fn(ct.params)                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    psi = fn(ct.params)
    torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t
    sharded_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    z = sharded_z_expectations(psi, SV_NQ, mesh)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    ref = statevector(ct, device=cuda)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t
    single_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    err = float((psi - ref).abs().max())
    z_err = float(np.abs(z - np.asarray(_z_from_state(ref, SV_NQ))).max())
    del psi, ref
    torch.cuda.empty_cache()
    print(f"27 sharded statevector, one rank on the card: {SV_NQ} qubits "
          f"(2^{SV_NQ} complex64 = {2 ** SV_NQ * 8 / 2 ** 30:.1f} GiB), "
          f"depth-2 Ising, {len(qc.ops)} ops: {sharded_s:.3f} s (peak "
          f"{sharded_peak:.2f} GiB) vs statevector {single_s:.3f} s (peak "
          f"{single_peak:.2f} GiB); state max|Δ| = {err:.3e}, <Z_q> max|Δ| "
          f"= {z_err:.3e} [{card}]")
    require(err <= 1e-5 and z_err <= 1e-5, f"27: sharded sv {err} {z_err}")

    t = time.perf_counter()
    rep = dryrun_multichip(8, device="cpu")
    print(f"27 dryrun_multichip(8, device='cpu'): 8 gloo ranks on this "
          f"machine's CPU (not the card): {time.perf_counter() - t:.1f} s; "
          f"errors {rep['errors']}")
    cpu_qc = random_circuit(SV_CPU_NQ, 6, seed=27)
    params = tensorize(cpu_qc).params
    t = time.perf_counter()
    out = spawn(sharded_sv_runs, 8, "cpu",
                [(cpu_qc, sp, [params]) for sp in (2, 4, 8)], "cpu")
    one = statevector(tensorize(cpu_qc), device="cpu").numpy()
    errs = [float(np.abs(runs[0][0] - one).max()) for runs in out]
    print(f"27 sharded statevector on 8 gloo CPU ranks (not the card), "
          f"{SV_CPU_NQ} qubits, sp = 2/4/8 vs one rank: max|Δ| = "
          f"{[f'{e:.3e}' for e in errs]} ({time.perf_counter() - t:.1f} s)")
    require(max(errs) <= 1e-5, f"27: CPU ranks {errs}")
    print("27: one card on this machine: no multi-GPU time exists; the "
          "multi-rank paths ran on CPU ranks")
    t = time.perf_counter()
    rep = dryrun_multichip(1, device="cuda")
    print(f"27 dryrun_multichip(1) on the card: {time.perf_counter() - t:.1f}"
          f" s (a spawned NCCL rank); errors {rep['errors']} [{card}]")
    phase_end("27", t0, card)


def artifacts_phase(card, cuda):
    """Phase 28: demo2's full artifact through the full gate, demo1's and
    the parity table's at --fast through the structure gate, the figures,
    and every tutorial and demo runner at fast=True."""
    import contextlib
    import importlib
    import io

    from mlqem_tpu_torch.workflows import figures
    from mlqem_tpu_torch.workflows.artifacts import main as write_artifact

    t0 = phase_begin()
    out_dir = os.path.join(ROOT, "artifacts_torch", "chip_smoke")
    runs = (
        ("demo2 (full protocol, check_demo2(full=True))",
         ["demo2"], ["demo2_4q_simulated.json"]),
        ("demo1 --fast (check_demo1(full=False))", ["demo1", "--fast"],
         ["demo1_100q_simulated.json", "demo1_100q_simulated_per_step.png",
          "demo1_100q_simulated_per_step_vs_ideal.png"]),
        (f"parity --fast, cut to seeds {PARITY_FAST_SEEDS} x settings "
         f"{PARITY_FAST_SETTINGS} (check_paper_parity(full=False))",
         ["parity", "--fast", "--seeds", *PARITY_FAST_SEEDS, "--settings",
          *PARITY_FAST_SETTINGS],
         ["paper_parity_table.json", "paper_parity_figure.png"]))
    for label, argv, files in runs:
        t = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            table = write_artifact(argv + ["--out", out_dir, "--device",
                                           cuda.type])
        wall = time.perf_counter() - t
        lines = buf.getvalue().strip().splitlines()
        print(f"28 {label}: {wall:.1f} s; " + " | ".join(
            line for line in lines if "mean:" in line or "PUBLISHED" in line
            or "random_forest" in line))
        for f in files:
            if f.endswith(".png") and not figures.available():
                print(f"28: matplotlib is not installed on this machine: "
                      f"{f} not drawn")
                continue
            path = os.path.join(out_dir, f)
            require(os.path.getsize(path) > 0, f"28: {f} not written")
        if argv[0] == "demo2":
            print(f"28 demo2: mean noisy {table['rmse_noisy_mean']:.5f} -> "
                  f"mitigated {table['rmse_mitigated_mean']:.5f} "
                  f"({table['improvement_mean']:.3f}x; published 1.57x) "
                  f"[{card}]")
    for runner in RUNNERS:
        main = importlib.import_module(
            f"mlqem_tpu_torch.tutorials.{runner}").main
        kwargs = ({"out_dir": os.path.join(out_dir, "z01")}
                  if runner == "z01_mlp_debug" else {})
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            main(device=cuda.type, fast=True, **kwargs)
        wall = time.perf_counter() - t
        lines = buf.getvalue().strip().splitlines()
        require(bool(lines), f"28: {runner} printed nothing")
        print(f"28 runner {runner} (fast): {wall:.1f} s; {lines[-1][:140]}")
    phase_end("28", t0, card)


def main():
    require(os.path.isdir(os.path.join(ROOT, "mlqem_tpu_torch")),
            f"no mlqem_tpu_torch package beside {__file__}")
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    import torch.distributed as dist

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
        if name in ("evolve", "frame_evolve", "fused_step"):
            require(spills and all(spills), f"{name}.cu spills registers "
                    f"({spills.count(False)} of {len(spills)} functions)")
        print(f"  {name}.cu: {spills.count(True)} of {len(spills)} functions "
              f"without register spills")
    if sys.argv[1:2] == ["--k2-tiers"]:
        require(len(sys.argv) == 3, "usage: chip_smoke.py --k2-tiers "
                "PARENT_FRAME_EVOLVE_CU")
        k2_tier_times(card, cuda, parent=parent_k2(sys.argv[2]))
        print(card)
        return

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
    torch.cuda.empty_cache()
    J0, rho0 = density_phases(card, cuda, device_model)
    estimator_phase(card, cuda, device_model, J0, rho0)
    torch.cuda.empty_cache()
    learning_flat_phase(card, cuda)
    learning_gnn_phase(card, cuda)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kicked_wide_phase(card, cuda)
    torch.cuda.empty_cache()
    workflow_phase(card, cuda)
    torch.cuda.empty_cache()
    demo1_phase(card, cuda)
    torch.cuda.synchronize()
    print(f"phases 17-19 wall time {time.perf_counter() - t0:.1f} s [{card}]")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pauli_prop_phase(card, cuda)
    torch.cuda.empty_cache()
    stabilizer_phase(card, cuda)
    torch.cuda.synchronize()
    print(f"phases 20-21 wall time {time.perf_counter() - t0:.1f} s [{card}]")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    wide_frame_phase(card, cuda)
    torch.cuda.empty_cache()
    vqe_dataset_phase(card, cuda)
    torch.cuda.empty_cache()
    h2_curve_phase(card, cuda)
    host_modules_phase(card, cuda)
    torch.cuda.synchronize()
    print(f"phases 22-25 wall time {time.perf_counter() - t0:.1f} s [{card}]")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh = mesh_phase(card, cuda)
    torch.cuda.empty_cache()
    sharded_sv_phase(card, cuda, mesh)
    torch.cuda.empty_cache()
    artifacts_phase(card, cuda)
    torch.cuda.synchronize()
    print(f"phases 26-28 wall time {time.perf_counter() - t0:.1f} s [{card}]")
    dist.destroy_process_group()                   # phase 26's one rank

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
