#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the float32 matmul settings, which must be IEEE f32 (no TF32);
2. build the fused evolution kernel from ``mlqem_tpu_torch/csrc/evolve.cu``;
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
5. time whole batches (pairs/min), the stages, and peak device memory.

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

ROOT = os.path.dirname(os.path.abspath(__file__))
NQ, STEPS, DT, N_TRAJ, SHOTS, BATCH = 10, 4, 0.25, 32, 10000, 16384
NOISY_ROWS = BATCH * N_TRAJ
TOL = 1e-5


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
    from mlqem_tpu_torch import KickedIsingEngine, configurable_device
    from mlqem_tpu_torch.utils.build import library_path

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    kev.load_library()
    print(f"build: evolve.cu built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    log = library_path("evolve") + ".log"
    if os.path.exists(log):
        with open(log) as f:
            for line in f:
                if "ptxas info" in line:
                    print("  " + line.strip())

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

    # alternate plain, kernel, kernel, plain on the same card
    plain_ms = [time_ms(run_plain, 2)]
    kernel_ms = [time_ms(run_kernel, 5), time_ms(run_kernel, 5)]
    plain_ms.append(time_ms(run_plain, 2))
    del args
    k_ms, p_ms = min(kernel_ms), min(plain_ms)
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
    ideal, noisy = eng.generate(J, seed=0)
    torch.cuda.synchronize()
    launches = kev.evolve_fused.launches
    print(f"main path: 1 batch of {BATCH} circuits x {N_TRAJ} trajectories, "
          f"{SHOTS} shots: evolve_fused launches = {launches}")
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
    eng.generate(J, seed=1)                     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    batch_s = []
    for seed in range(2, 7):
        Jb = rng.uniform(0.05, 0.6, size=BATCH).astype(np.float32)
        t0 = time.perf_counter()
        eng.generate(Jb, seed=seed)             # ends in a host copy
        batch_s.append(time.perf_counter() - t0)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    med = statistics.median(batch_s)
    print(f"pairs/min: {BATCH * 60.0 / med:.0f} (median of "
          f"{len(batch_s)} batches, {med * 1e3:.1f} ms/batch; best "
          f"{BATCH * 60.0 / min(batch_s):.0f}; batches "
          f"{[round(s * 1e3, 1) for s in batch_s]} ms) [{card}]")
    print(f"peak device memory: {peak_gib:.2f} GiB "
          f"(torch.cuda.max_memory_allocated) [{card}]")

    stage_ms = {}
    for seed in range(7, 10):
        gen = torch.Generator(device=cuda)
        gen.manual_seed(seed)
        Jt = torch.as_tensor(J, device=cuda)
        torch.cuda.synchronize()
        last = [time.perf_counter()]

        def mark(stage):
            torch.cuda.synchronize()
            now = time.perf_counter()
            stage_ms.setdefault(stage, []).append((now - last[0]) * 1e3)
            last[0] = now

        eng.run(Jt, gen, mark=mark)
    split = {k: statistics.median(v) for k, v in stage_ms.items()}
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

    record = {"kernels": [{
        "name": "evolve_fused", "route": "cuda",
        "source": "mlqem_tpu_torch/csrc/evolve.cu",
        "replaces": "mlqem_tpu/ops/pallas/evolve.py:107",
        "launches": launches, "max_abs_err": big_err,
        "ms": k_ms, "plain_ms": p_ms}]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
