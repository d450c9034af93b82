"""The port's CUDA kernels on the card (marked ``cuda``; skips without one).

This file imports neither JAX nor ``mlqem_tpu``, so it also runs where only
PyTorch is installed::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""
import hashlib

import numpy as np
import pytest
import torch

from mlqem_tpu_torch import (IsingLabelPipeline, KickedIsingEngine,
                             LightconeIsing, configurable_device)
from mlqem_tpu_torch.convert import engine_tables_from_numpy
from mlqem_tpu_torch.ops.kernels import evolve as kev
from mlqem_tpu_torch.ops.kernels import frame_evolve as fe
from mlqem_tpu_torch.ops.kernels import frames as kfr
from mlqem_tpu_torch.ops.kernels import fused_step as kfs
from mlqem_tpu_torch.ops.kernels import wht as kwht
from mlqem_tpu_torch.ops.frame_trajectory import frame_plan
from mlqem_tpu_torch.ops.kicked_ising import _sign_tables
from mlqem_tpu_torch.parallel.datagen import make_ising_template

from lightcone_windows import window_bonds

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90) and nvcc")
    return torch.device("cuda")


def _inputs(nq, rows, steps, device, seed=0):
    rng = np.random.default_rng(seed)
    bit_pm, bond_par = _sign_tables(nq)
    nb = bond_par.shape[1]
    re = np.zeros((rows, 2 ** nq))
    re[:, 0] = 1.0
    arrays = [re, np.zeros_like(re),
              rng.choice([-1., 1.], size=(rows, steps * nq)),
              rng.choice([-1., 1.], size=(rows, steps * nb)),
              rng.uniform(-1.2, -0.1, size=(rows, 1)), bit_pm.T, bond_par.T]
    return [torch.as_tensor(np.ascontiguousarray(a, np.float32),
                            device=device) for a in arrays], nb


@pytest.mark.parametrize("nq,rows", [(2, 3), (6, 33), (8, 4099),
                                     (10, 1000), (13, 17)])
def test_kernel_matches_reference(nq, rows, cuda_device):
    args, nb = _inputs(nq, rows, 4, cuda_device)
    before = kev.evolve_fused.launches
    re, im = kev.evolve_fused(*args, 0.5, 4, nq, nb)
    ref_re, ref_im = kev.evolve_fused_reference(*args, 0.5, 4, nq, nb)
    torch.cuda.synchronize()
    assert kev.evolve_fused.launches == before + 1
    assert (re - ref_re).abs().max().item() <= 1e-5
    assert (im - ref_im).abs().max().item() <= 1e-5


def _random_start_inputs(nq, rows, steps, device, seed, odd_rows=()):
    """Unit-norm random start states; the rows in ``odd_rows`` get kick and
    bond signs other than ±1."""
    args, nb = _inputs(nq, rows, steps, device, seed)
    rng = np.random.default_rng(seed + 100)
    re = rng.normal(size=(rows, 2 ** nq))
    im = rng.normal(size=(rows, 2 ** nq))
    norm = np.sqrt((re ** 2 + im ** 2).sum(axis=1, keepdims=True))
    args[0] = torch.as_tensor((re / norm).astype(np.float32), device=device)
    args[1] = torch.as_tensor((im / norm).astype(np.float32), device=device)
    for r in odd_rows:
        args[2][r] *= torch.as_tensor(
            rng.uniform(0.5, 1.5, size=steps * nq).astype(np.float32),
            device=device)
        if nb:
            args[3][r] *= torch.as_tensor(
                rng.uniform(0.5, 1.5, size=steps * nb).astype(np.float32),
                device=device)
    return args, nb


# one nq on each side of every register / shuffle / shared-memory split,
# then rows whose kick and bond signs are not all ±1
@pytest.mark.parametrize("nq,rows,odd", [
    (1, 37, False), (4, 301, False), (5, 33, False), (6, 65, False),
    (10, 999, False), (11, 9, False), (13, 3, False), (3, 40, True),
    (10, 50, True), (12, 6, True)])
def test_kernel_matches_reference_from_random_states(nq, rows, odd,
                                                     cuda_device):
    args, nb = _random_start_inputs(nq, rows, 4, cuda_device, seed=nq,
                                    odd_rows=range(0, rows, 3) if odd else ())
    before = kev.evolve_fused.launches
    got = kev.evolve_fused(*args, 0.5, 4, nq, nb)
    want = kev.evolve_fused_reference(*args, 0.5, 4, nq, nb)
    torch.cuda.synchronize()
    assert kev.evolve_fused.launches == before + 1
    for g_, w_ in zip(got, want):
        assert (g_ - w_).abs().max().item() <= 1e-5


# SHA-256 of K1's re and im outputs on the cases of the two tests above,
# from the build of csrc/evolve.cu before its device code moved into
# csrc/kicked_regs.cuh: the move left K1 unchanged bit for bit.
K1_DIGESTS = {
    "zero-2-3-":
        "0b5e42b463a1f7bf97b1a3329867f07b2ddae0155ef53367257aa0c5267b2e9e",
    "zero-6-33-":
        "49c985f724b4beb3d31a5e3dc4fe2203009721bf13fb755c6bf18bb2d0f36dcf",
    "zero-8-4099-":
        "22ff7903f7672792548ce91a7a7ac812e3c1b0d4de57d5a53501b437b23811d0",
    "zero-10-1000-":
        "cd68fcb6a3d928c9f55918ffd2a4f3eb762a553519d0498bc5f810351adf2ce8",
    "zero-13-17-":
        "c0f50871fa17774393d007c5731d13c712c5ea153540f67e9c6da457961d9bde",
    "random-1-37-":
        "93f86019d5b1975ff57e5d218eb2ed9cfa43592286ade39530aad7e82980748d",
    "random-4-301-":
        "8d4c7cea9c8f8948ca1b2298e984014d0756f7e73f450ec76c624d70e8a7682b",
    "random-5-33-":
        "a11167a1f9ad11e9a25d226f8f4fde17377a3708d6251304bfa5be3e9adfc542",
    "random-6-65-":
        "4d639bed27f33969e4ec4698cea350a9d9eac054b7755a4fe2c6c3962f6abc5a",
    "random-10-999-":
        "4ae895122813ec29dc340bed33764d499026a2d7e017f372e277cf0622d3cca5",
    "random-11-9-":
        "7b1e6835ffec29767c4a7b849e0dd34a6d8f76adb6096619a96574fc0cdd56e0",
    "random-13-3-":
        "468adcd5f160bcabbdfb661ebcac7f9ebb021df24e57cb4448f3262974f10aa5",
    "random-3-40-odd":
        "5fe314b0551493ed5489ffffcf8c59d4f21702e1a08373a5747440294f576085",
    "random-10-50-odd":
        "8b5a5f10e22d0a69a819d2d0825d0ffcf12e6835db09c8852801eda3430d91ff",
    "random-12-6-odd":
        "c65e08a1dacac5a82f698f0baf04e1c658c84a3b81a8b0391f68f92ed4e4ccdf",
}


def _k1_case(name, device):
    """(args, nq, nb) of a case of the two tests above, by its name."""
    start, nq, rows, odd = name.split("-")
    nq, rows = int(nq), int(rows)
    if start == "zero":
        args, nb = _inputs(nq, rows, 4, device)
    else:
        args, nb = _random_start_inputs(
            nq, rows, 4, device, seed=nq,
            odd_rows=range(0, rows, 3) if odd == "odd" else ())
    return args, nq, nb


def _k1_digest(name, device, evolve_fused):
    args, nq, nb = _k1_case(name, device)
    digest = hashlib.sha256()
    for t in evolve_fused(*args, 0.5, 4, nq, nb):
        digest.update(t.cpu().numpy().tobytes())
    return digest.hexdigest()


K1_CASE_NAMES = (
    [f"zero-{nq}-{rows}-" for nq, rows in [(2, 3), (6, 33), (8, 4099),
                                           (10, 1000), (13, 17)]]
    + [f"random-{nq}-{rows}-{'odd' if odd else ''}" for nq, rows, odd in [
        (1, 37, False), (4, 301, False), (5, 33, False), (6, 65, False),
        (10, 999, False), (11, 9, False), (13, 3, False), (3, 40, True),
        (10, 50, True), (12, 6, True)]])


@pytest.mark.parametrize("name", K1_CASE_NAMES)
def test_kernel_unchanged_bit_for_bit(name, cuda_device):
    assert _k1_digest(name, cuda_device, kev.evolve_fused) == K1_DIGESTS[name]


def test_kernel_poisons_output_on_non_sign_tables(cuda_device):
    args, nb = _inputs(6, 8, 2, cuda_device)
    args[5] = args[5] * 0.5
    re, im = kev.evolve_fused(*args, 0.5, 2, 6, nb)
    assert torch.isnan(re).all() and torch.isnan(im).all()


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    args, nb = _inputs(6, 8, 2, cuda_device)
    with pytest.raises(ValueError, match="shape"):
        kev.evolve_fused(*args, 0.5, 3, 6, nb)
    bad = list(args)
    bad[0] = args[0].double()
    with pytest.raises(TypeError):
        kev.evolve_fused(*bad, 0.5, 2, 6, nb)
    bad[0] = args[0].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        kev.evolve_fused(*bad, 0.5, 2, 6, nb)
    bad = list(args)
    bad[2] = args[2].cpu()
    with pytest.raises(ValueError, match="kick_signs is on cpu"):
        kev.evolve_fused(*bad, 0.5, 2, 6, nb)
    with pytest.raises(ValueError, match="nq"):
        big, nb14 = _inputs(14, 2, 1, cuda_device)
        kev.evolve_fused(*big, 0.5, 1, 14, nb14)


def test_engine_kernel_matches_plain_path(cuda_device):
    J = np.random.default_rng(1).uniform(0.05, 0.6, size=8)
    out = []
    for use_kernel in (True, False):
        eng = KickedIsingEngine(configurable_device(10, seed=0), nq=10,
                                steps=4, device=cuda_device, n_traj=16,
                                shots=None, use_kernel=use_kernel)
        out.append(eng.generate(J, seed=3))
    for got, want in zip(*out):
        assert got.shape == (8, 10)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("nq,kernel,per_step", [
    (14, "fused_trotter_step", 1), (20, "fused_trotter_step", 1)])
def test_engine_above_k1_width_matches_plain_path(nq, kernel, per_step,
                                                  cuda_device):
    """Above K1's 13 qubits the engine runs K3 a step at a time (its chip
    tier at nq 14, its wide tier at nq 20); it used to raise at its first
    batch."""
    J = np.random.default_rng(2).uniform(0.05, 0.6, size=3)
    counters = {"evolve_fused": kev.evolve_fused,
                "fused_trotter_step": kfs.fused_trotter_step,
                "wht_planes": kwht.wht_planes}
    out, launches = [], []
    for use_kernel in (True, False):
        eng = KickedIsingEngine(configurable_device(nq, seed=0), nq=nq,
                                steps=3, device=cuda_device, n_traj=4,
                                shots=None, use_kernel=use_kernel)
        before = {k: f.launches for k, f in counters.items()}
        out.append(eng.generate(J, seed=3))
        launches.append({k: f.launches - before[k]
                         for k, f in counters.items()})
    # the noisy arm and the ideal arm, 3 steps each
    want = {k: 0 for k in counters}
    want[kernel] = 2 * 3 * per_step
    assert launches == [want, {k: 0 for k in counters}]
    for got, ref in zip(*out):
        assert got.shape == (3, nq)
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("nq,rows", [(1, 3), (2, 5), (5, 1000), (10, 4099),
                                     (11, 257), (12, 131), (13, 17),
                                     (14, 600), (15, 9), (16, 7), (17, 5),
                                     (18, 3), (20, 2)])
def test_frame_kernel_matches_reference(nq, rows, cuda_device):
    rng = np.random.default_rng(nq)
    plan, n_rot = fe.every_kind_plan(rng, nq, 148)
    theta = torch.as_tensor(rng.uniform(-3, 3, size=(rows, n_rot)),
                            dtype=torch.float32, device=cuda_device)
    before = fe.evolve_frame_marginals.launches
    got = fe.evolve_frame_marginals(theta, plan, nq)
    want = fe.evolve_frame_marginals_reference(theta, plan, nq)
    torch.cuda.synchronize()
    assert fe.evolve_frame_marginals.launches == before + 1
    assert got.shape == (rows, nq)
    assert (got - want).abs().max().item() <= 2e-5


# each side of the warp tier's register / lane splits, the chip tier
# (nq 11-14: 8 to 1 rows a block) and the pass tier (nq 15-20)
@pytest.mark.parametrize("nq,rows", [(1, 67), (4, 129), (6, 65), (10, 999),
                                     (11, 9), (12, 7), (13, 5), (14, 3),
                                     (15, 2), (16, 3), (18, 2), (20, 1)])
def test_frame_kernel_runs_every_code_path(nq, rows, cuda_device):
    """Every kind moves every qubit: each register position and the lane
    path of rx, ry, h, cx, cy and swap."""
    rng = np.random.default_rng(nq + 100)
    plan, n_rot = fe.every_path_plan(rng, nq)
    theta = torch.as_tensor(rng.uniform(-3, 3, size=(rows, n_rot)),
                            dtype=torch.float32, device=cuda_device)
    before = fe.evolve_frame_marginals.launches
    got = fe.evolve_frame_marginals(theta, plan, nq)
    want = fe.evolve_frame_marginals_reference(theta, plan, nq)
    torch.cuda.synchronize()
    assert fe.evolve_frame_marginals.launches == before + 1
    assert (got - want).abs().max().item() <= 2e-5


@pytest.mark.parametrize("nq,rows", [(11, 33), (12, 17), (14, 9), (15, 5),
                                     (16, 3), (20, 2)])
def test_frame_kernel_runs_the_ising_schedule(nq, rows, cuda_device):
    """The Ising template (2 steps) through the chip tier's relayouts and
    the pass tier's passes, one counted launch a call."""
    tpl = make_ising_template(nq, 2, "Z", 0.25, h=1.0)
    plan, meta = frame_plan(tpl.bind_host(
        np.zeros(tpl.num_parameters, np.float32)))
    theta = torch.as_tensor(
        np.random.default_rng(nq).uniform(-3, 3, size=(rows, len(meta))),
        dtype=torch.float32, device=cuda_device)
    before = fe.evolve_frame_marginals.launches
    got = fe.evolve_frame_marginals(theta, plan, nq)
    want = fe.evolve_frame_marginals_reference(theta, plan, nq)
    torch.cuda.synchronize()
    assert fe.evolve_frame_marginals.launches == before + 1
    assert (got - want).abs().max().item() <= 2e-5


def test_frame_kernel_runs_merged_plans(cuda_device):
    """The bench template's plan, which the wrapper runs merged (148 ops as
    76), against the plain version of the plan as given."""
    tpl = make_ising_template(10, 4, "Z", 0.25, h=1.0)
    plan, meta = frame_plan(tpl.bind_host(
        np.zeros(tpl.num_parameters, np.float32)))
    assert len(fe.fuse_plan(plan)) == 76
    rng = np.random.default_rng(5)
    theta = torch.as_tensor(rng.uniform(-3, 3, size=(1001, len(meta))),
                            dtype=torch.float32, device=cuda_device)
    got = fe.evolve_frame_marginals(theta, plan, 10)
    want = fe.evolve_frame_marginals_reference(theta, plan, 10)
    assert (got - want).abs().max().item() <= 2e-5


@pytest.mark.parametrize("nq", [2, 6])
def test_frame_kernel_with_more_angles_than_its_table_holds(nq,
                                                            cuda_device):
    """1200 angles for 16-32 rows a warp: the per-warp cos/sin table does
    not fit in shared memory, and the lanes take each op's sincosf."""
    rng = np.random.default_rng(nq)
    kinds = (fe.ROT_X, fe.ROT_Y, fe.ROT_Z, fe.ROT_ZZ)
    plan = tuple((kinds[i % 4], i % nq, (i + 1) % nq, i)
                 for i in range(1200))
    theta = torch.as_tensor(rng.uniform(-3, 3, size=(37, 1200)),
                            dtype=torch.float32, device=cuda_device)
    got = fe.evolve_frame_marginals(theta, plan, nq)
    want = fe.evolve_frame_marginals_reference(theta, plan, nq)
    assert (got - want).abs().max().item() <= 2e-5


def test_frame_kernel_without_rotations(cuda_device):
    plan = ((fe.GATE_H, 0, 1, -1), (fe.GATE_CX, 0, 2, -1),
            (fe.GATE_CY, 2, 1, -1), (fe.GATE_SWAP, 0, 1, -1),
            (fe.GATE_H, 2, 0, -1), (fe.GATE_CZ, 1, 2, -1))
    theta = torch.zeros((7, 0), device=cuda_device)
    got = fe.evolve_frame_marginals(theta, plan, 3)
    want = fe.evolve_frame_marginals_reference(torch.zeros((7, 1)), plan, 3)
    assert (got.cpu() - want).abs().max().item() <= 2e-5


def test_frame_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    plan = ((fe.ROT_X, 0, 1, 0), (fe.GATE_CX, 0, 1, -1))
    theta = torch.zeros((4, 1), device=cuda_device)
    with pytest.raises(ValueError, match="rows, n_rot"):
        fe.evolve_frame_marginals(theta[:, 0], plan, 2)
    with pytest.raises(TypeError):
        fe.evolve_frame_marginals(theta.double(), plan, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fe.evolve_frame_marginals(torch.zeros((2, 4), device=cuda_device).t(),
                                  plan, 2)
    with pytest.raises(ValueError, match="nq"):
        fe.evolve_frame_marginals(theta, plan, fe.MAX_NQ + 1)
    with pytest.raises(ValueError, match="unknown plan kind"):
        fe.evolve_frame_marginals(theta, ((12, 0, 1, -1),), 2)
    with pytest.raises(ValueError, match="slot"):
        fe.evolve_frame_marginals(theta, ((fe.ROT_Y, 0, 1, 3),), 2)
    with pytest.raises(ValueError, match="shared memory"):
        fe.evolve_frame_marginals(theta, ((fe.GATE_H, 0, 1, -1),) * 12000,
                                  13)


def test_frame_pipeline_kernel_matches_plain_path(cuda_device):
    J = np.random.default_rng(1).uniform(0.05, 0.6, size=8)
    out = []
    for use_kernel in (True, False):
        pipe = IsingLabelPipeline(configurable_device(10, seed=0), nq=10,
                                  steps=4, device=cuda_device, shots=None,
                                  method="frame", n_traj=16,
                                  use_kernel=use_kernel)
        before = fe.evolve_frame_marginals.launches
        out.append(pipe.generate(J, seed=3))
        assert fe.evolve_frame_marginals.launches == before + use_kernel
    for got, want in zip(*out):
        assert got.shape == (8, 10)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("method, engine", [
    ("frame", "k2"), ("trajectory", "k2"),
    ("trajectory_gather", "trajectory_gather")])
def test_frame_pipeline_above_k2_width_card_matches_cpu(method, engine,
                                                        cuda_device,
                                                        monkeypatch):
    """At nq 14 the pipeline picks its engine at construction and runs on
    the card, ``"frame"`` and ``"trajectory"`` through K2's chip tier (one
    launch), ``"trajectory_gather"`` through the gather engine: card vs
    CPU on shared draws (``shots=None``) ≤ 1e-5."""
    import mlqem_tpu_torch.ops.sampling as t_sampling

    nq, B, T = 14, 4, 4
    J = np.random.default_rng(3).uniform(0.05, 0.6, size=B)
    out = []
    for d in (cuda_device, "cpu"):
        pipe = IsingLabelPipeline(configurable_device(nq, seed=0), nq=nq,
                                  steps=2, device=d, shots=None,
                                  method=method, n_traj=T)
        assert pipe.noisy_engine == (engine if d is cuda_device else
                                     "k2" if method == "frame" else
                                     "trajectory_gather")
        rng = np.random.default_rng(5)
        draws = rng.integers(0, 16, size=(B, T, pipe.ct_struct.max_ops))
        draws[rng.random(draws.shape) < 0.7] = 0
        monkeypatch.setattr(
            t_sampling, "sample_small_categorical",
            lambda probs, shape, gen, _d=draws, _dev=pipe.device:
            torch.as_tensor(_d.astype(np.int32), device=_dev))
        before = fe.evolve_frame_marginals.launches
        out.append(pipe.generate(J, seed=0))
        assert fe.evolve_frame_marginals.launches == before + (
            engine == "k2" and pipe.device.type == "cuda")
    for got, want in zip(*out):
        assert got.shape == (B, nq)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# the last ten cases: each side of every register / shuffle / exchange /
# pass split of the kernel
@pytest.mark.parametrize("nq,rows", [(1, 3), (5, 1), (8, 33), (13, 7),
                                     (14, 3), (17, 2), (21, 1), (1, 1),
                                     (4, 7), (5, 9), (6, 1), (12, 7), (13, 1),
                                     (14, 1), (18, 3), (21, 3), (22, 1)])
def test_wht_kernel_matches_reference(nq, rows, cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(nq)
    re = torch.randn((rows, 2 ** nq), device=cuda_device, generator=g)
    im = torch.randn((rows, 2 ** nq), device=cuda_device, generator=g)
    want = kwht.wht_planes_reference(re, im, nq)
    before = kwht.wht_planes.launches
    got = kwht.wht_planes(re, im, nq)
    torch.cuda.synchronize()
    assert kwht.wht_planes.launches == before + 1
    assert got[0] is re and got[1] is im
    for g_, w_ in zip(got, want):
        assert (g_ - w_).abs().max().item() <= 2e-6 * w_.abs().max().item()


def test_wht_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    re = torch.zeros((2, 16), device=cuda_device)
    with pytest.raises(ValueError, match="shape"):
        kwht.wht_planes(re, torch.zeros((2, 8), device=cuda_device), 4)
    with pytest.raises(TypeError):
        kwht.wht_planes(re, re.double(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        kwht.wht_planes(re, torch.zeros((16, 2), device=cuda_device).t(), 4)
    with pytest.raises(ValueError, match="distinct"):
        kwht.wht_planes(re, re, 4)
    flat = torch.zeros(3 * 16 + 1, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        kwht.wht_planes(flat[1:17].view(1, 16), flat[17:33].view(1, 16), 4)
    with pytest.raises(ValueError, match="nq"):
        kwht.wht_planes(re, torch.zeros_like(re), 31)


def _step_inputs(nq, rows, device, seed=0):
    rng = np.random.default_rng(seed)
    bit_pm, bond_par = _sign_tables(nq)
    nb = bond_par.shape[1]
    re = rng.normal(size=(rows, 2 ** nq))
    im = rng.normal(size=(rows, 2 ** nq))
    norm = np.sqrt((re ** 2 + im ** 2).sum(axis=1, keepdims=True))
    arrays = [re / norm, im / norm, rng.choice([-1., 1.], size=(rows, nq)),
              rng.choice([-1., 1.], size=(rows, nb)),
              rng.uniform(-1.2, -0.1, size=(rows, 1)), bit_pm, bond_par]
    return [torch.as_tensor(np.ascontiguousarray(a, np.float32),
                            device=device) for a in arrays]


# the last cases: one nq on each side of every geometry split
@pytest.mark.parametrize("nq,rows", [(1, 2), (3, 5), (7, 33), (10, 1000),
                                     (13, 17), (14, 3), (1, 70), (5, 33),
                                     (11, 9), (12, 7), (14, 1)])
def test_step_kernel_matches_reference(nq, rows, cuda_device):
    args = _step_inputs(nq, rows, cuda_device)
    before = kfs.fused_trotter_step.launches
    got = kfs.fused_trotter_step(*args, 0.9)
    want = kfs.fused_trotter_step_reference(*args, 0.9)
    torch.cuda.synchronize()
    assert kfs.fused_trotter_step.launches == before + 1
    for g_, w_ in zip(got, want):
        assert (g_ - w_).abs().max().item() <= 1e-5


@pytest.mark.parametrize("nq", [6, 14])
def test_step_kernel_poisons_output_on_non_sign_tables(nq, cuda_device):
    args = _step_inputs(nq, 3, cuda_device)
    args[6] = args[6] * 0.5
    re, im = kfs.fused_trotter_step(*args, 0.5)
    assert torch.isnan(re).all() and torch.isnan(im).all()


def _relative_err(got, want):
    """max|Δ| over each row's largest |amplitude|, both planes."""
    scale = torch.maximum(want[0].abs().amax(dim=1),
                          want[1].abs().amax(dim=1))[:, None]
    return max(((g - w_).abs() / scale).max().item()
               for g, w_ in zip(got, want))


@pytest.mark.parametrize("nq,rows", [(15, 5), (16, 3), (18, 2), (21, 2)])
def test_step_wide_tier_matches_reference(nq, rows, cuda_device):
    """K3's wide tier (passes over device memory) against the plain
    version, one launch a call, with the chain's nb = nq - 1 bonds."""
    args = _step_inputs(nq, rows, cuda_device)
    inputs = [a.clone() for a in args]
    before = (kfs.fused_trotter_step.launches, kfs.step_masks.launches)
    got = kfs.fused_trotter_step(*args, 0.9)
    want = kfs.fused_trotter_step_reference(*args, 0.9)
    torch.cuda.synchronize()
    assert (kfs.fused_trotter_step.launches - before[0],
            kfs.step_masks.launches - before[1]) == (1, 1)
    assert all(torch.equal(a, b) for a, b in zip(args, inputs))
    assert _relative_err(got, want) <= 1e-5
    # masks built once serve every step
    masks = kfs.step_masks(args[5], args[6])
    again = kfs.fused_trotter_step(*args, 0.9, masks=masks)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def test_step_wide_tier_poisons_and_takes_other_signs(cuda_device):
    """A table entry other than ±1 makes every output NaN; a row whose
    signs are not all ±1 gets the plain version's result."""
    args = _step_inputs(16, 3, cuda_device)
    bad = list(args)
    bad[5] = args[5] * 0.5
    re, im = kfs.fused_trotter_step(*bad, 0.5)
    assert torch.isnan(re).all() and torch.isnan(im).all()
    odd = list(args)
    odd[2] = args[2].clone()
    odd[2][1, 3] = 0.25
    odd[3] = args[3].clone()
    odd[3][2, 0] = -2.0
    got = kfs.fused_trotter_step(*odd, 0.5)
    want = kfs.fused_trotter_step_reference(*odd, 0.5)
    assert _relative_err(got, want) <= 1e-5


# SHA-256 of K3's chip-tier outputs (re, then im) on _step_inputs(nq, 7,
# seed=nq) at theta_h 0.9, from the build before the wide tier
K3_CHIP_DIGESTS = {
    13: "eeb24076e70cae02b2e57ff441522e57dc4ea9508c94b47ff75ddde37225c60a",
    14: "9f256e7eb3275e57c8d4d36e2f36fa23f9609a868342bf90342a31386dce6136",
}


@pytest.mark.parametrize("nq", [13, 14])
def test_step_chip_tier_unchanged_bit_for_bit(nq, cuda_device):
    digest = hashlib.sha256()
    for t in kfs.fused_trotter_step(*_step_inputs(nq, 7, cuda_device,
                                                  seed=nq), 0.9):
        digest.update(t.cpu().numpy().tobytes())
    assert digest.hexdigest() == K3_CHIP_DIGESTS[nq]


@pytest.mark.parametrize("nq", [1, 5, 6, 10, 11, 13])
def test_step_kernel_equals_k1_at_one_step(nq, cuda_device):
    """K3 and K1 run the same device code (csrc/kicked_regs.cuh): one step
    of K1 on K1's table layout equals K3 bit for bit."""
    args = _step_inputs(nq, 37, cuda_device, seed=nq)
    got = kfs.fused_trotter_step(*args, 0.9)
    k1 = args[:5] + [args[5].t().contiguous(), args[6].t().contiguous()]
    want = kev.evolve_fused(*k1, 0.9, 1, nq, args[3].shape[1])
    for g_, w_ in zip(got, want):
        assert torch.equal(g_.view(torch.int32), w_.view(torch.int32))


def test_kicked_engine_refuses_tf32(cuda_device):
    """⟨Z⟩ = probs @ (−bit_pm) must run at IEEE f32: with TF32 on, the
    engine raises rather than round the probabilities to 10 bits."""
    eng = KickedIsingEngine(configurable_device(6, seed=0), nq=6, steps=2,
                            device=cuda_device, n_traj=4, shots=None)
    J = np.array([0.2, 0.4])
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="TF32"):
            eng.generate(J, seed=0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    ideal, _ = eng.generate(J, seed=0)
    assert np.isfinite(ideal).all()


def test_kicked_readout_on_marginals_at_full_rows(cuda_device):
    """Stage (d) at nq 10 and 4,096 circuits × 32 trajectories: the
    marginal readout matches the confusion of the whole distribution, and
    allocates a small share of the probabilities' bytes.

    cuBLAS sums a row's 1,024 terms in f32 one after another, so each path
    is ~1e-6 off its float64 value on the card: both are held to
    √(2^nq)·2^−24 (1.9e-6), the typical error of such a sum of total 1.
    """
    from mlqem_tpu_torch.ops.density import apply_readout_confusion

    nq, T, B = 10, 32, 4096
    eng = KickedIsingEngine(configurable_device(nq, seed=0), nq=nq,
                            steps=1, device=cuda_device, n_traj=T)
    rng = np.random.default_rng(0)
    p10, p01 = rng.uniform(0.005, 0.05, nq), rng.uniform(0.06, 0.15, nq)
    eng.tables = engine_tables_from_numpy(
        eng.tables.bond_probs.cpu().numpy(),
        np.array([[1 - p10, p01], [p10, 1 - p01]]).transpose(2, 0, 1),
        cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    probs = torch.rand((B * T, 2 ** nq), device=cuda_device,
                       generator=gen) ** 4
    probs /= probs.sum(dim=1, keepdim=True)
    flip = 1.0 - 2.0 * (torch.rand((B * T, nq), device=cuda_device,
                                   generator=gen) < 0.3).float()
    want = (apply_readout_confusion(probs, eng.tables.confusion, nq)
            @ eng._neg_bit_pm) * flip
    exact = (apply_readout_confusion(probs.double(),
                                     eng.tables.confusion.double(), nq)
             @ eng._neg_bit_pm.double()) * flip.double()
    eng.trajectory_z(probs[:T], flip[:T])            # cuBLAS's workspace
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    got = eng.trajectory_z(probs, flip)
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated() - before
    assert grew < 0.1 * probs.numel() * probs.element_size()
    assert got.shape == (B, T, nq)
    got = got.reshape(B * T, nq)
    tol = 2.0 ** (nq / 2 - 24)
    assert (got - want).abs().max().item() <= tol
    assert (got.double() - exact).abs().max().item() <= tol


def test_step_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    args = _step_inputs(6, 8, cuda_device)
    bad = list(args)
    bad[5] = args[5].t().contiguous()
    with pytest.raises(ValueError, match="bit_pm has shape"):
        kfs.fused_trotter_step(*bad, 0.5)
    bad = list(args)
    bad[2] = args[2].cpu()
    with pytest.raises(ValueError, match="kick_signs is on cpu"):
        kfs.fused_trotter_step(*bad, 0.5)
    # the width and bond count are read from the signs, before any table
    bad = list(args)
    bad[2] = torch.ones((8, kfs.MAX_NQ + 1), device=cuda_device)
    with pytest.raises(ValueError, match="nq"):
        kfs.fused_trotter_step(*bad, 0.5)
    wide = _step_inputs(15, 1, cuda_device)
    wide[3] = torch.ones((1, kfs.MAX_NB + 1), device=cuda_device)
    with pytest.raises(ValueError, match="nb"):
        kfs.fused_trotter_step(*wide, 0.5)
    with pytest.raises(ValueError, match="masks"):
        kfs.fused_trotter_step(*_step_inputs(15, 1, cuda_device), 0.5,
                               masks=torch.zeros(3, dtype=torch.int32,
                                                 device=cuda_device))


@pytest.mark.parametrize("nq,steps", [(12, 3), (20, 7)])
def test_lightcone_kernel_matches_plain_path(nq, steps, cuda_device):
    """w=7 runs through K3's chip tier, w=15 through its wide tier; the
    same draws on both."""
    J = np.array([0.2, 0.5], np.float32)
    out, launches = [], []
    for use_kernel in (True, False):
        lc = LightconeIsing(configurable_device(nq, seed=1), nq=nq,
                            steps=steps, device=cuda_device, dt=0.5, h=1.3,
                            n_traj=16, t_chunk=8, shots=None,
                            use_kernel=use_kernel)
        before = (kfs.fused_trotter_step.launches, kwht.wht_planes.launches)
        out.append(lc.generate_stepwise(J, qubits=(0, nq // 2), seed=4))
        launches.append((kfs.fused_trotter_step.launches - before[0],
                         kwht.wht_planes.launches - before[1]))
    # 2 windows x steps x (2 noisy chunks + the ideal arm)
    calls = 2 * steps * 3
    assert launches[0] == (calls, 0)
    assert launches[1] == (0, 0)
    for got, want in zip(*out):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _chain_bonds(nq):
    """The kicked engine's bond order: even bonds, then odd."""
    return ([(q, q + 1) for q in range(0, nq - 1, 2)]
            + [(q, q + 1) for q in range(1, nq - 1, 2)])


# (nq, bonds, rows, steps) of the frame pass: the labels cell's shape, nf1's
# windows at w 13, 17, 21 (starts 0, odd and even), the widest engine, rows
# that are no multiple of the kernel's 128-row block
K5_CASES = {
    "labels": lambda: (10, _chain_bonds(10), 524288, 4),
    "w13-start0": lambda: (*window_bonds(6, 3), 128, 10),
    "w13-start5": lambda: (*window_bonds(6, 11), 128, 10),
    "w17-start0": lambda: (*window_bonds(8, 2), 128, 10),
    "w17-start46": lambda: (*window_bonds(8, 54), 128, 10),
    "w21-start0": lambda: (*window_bonds(10, 0), 128, 10),
    "w21-start1": lambda: (*window_bonds(10, 11), 128, 10),
    "w21-start44": lambda: (*window_bonds(10, 54), 128, 10),
    "nq30-1step": lambda: (30, _chain_bonds(30), 1000, 1),
    "ragged": lambda: (10, _chain_bonds(10), 1000, 3),
    "one-row": lambda: (5, _chain_bonds(5), 1, 3),
    "no-bonds": lambda: (1, [], 200, 2),
}


def _k5_draws(steps, rows, nb, device, seed):
    """Uniform Paulis, the first 16 of them 0..15 in turn: every Pauli
    pair appears."""
    rng = np.random.default_rng(seed)
    draws = rng.integers(0, 16, size=(steps, rows, nb, 2), dtype=np.int32)
    flat = draws.reshape(-1)
    flat[:min(16, flat.size)] = np.arange(min(16, flat.size))
    return torch.as_tensor(draws, device=device)


@pytest.mark.parametrize("case", list(K5_CASES))
def test_frames_kernel_matches_reference(case, cuda_device):
    nq, bonds, rows, steps = K5_CASES[case]()
    assert case != "w21-start1" or bonds[0] == (1, 2)
    draws = _k5_draws(steps, rows, len(bonds), cuda_device, seed=rows + nq)
    if draws.numel() >= 16:
        assert torch.unique(draws).numel() == 16
    before = kfr.propagate_frames.launches
    got = kfr.propagate_frames(draws, bonds, nq)
    want = kfr.propagate_frames_reference(draws, bonds, nq)
    torch.cuda.synchronize()
    assert kfr.propagate_frames.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    # a step's kick signs come before its bonds: the first step's are +1
    if rows >= 128 and bonds:
        assert (got[1] == -1).any()
        assert steps == 1 or (got[0] == -1).any()


def test_frame_signs_launch_k5_once_a_call(cuda_device):
    """Each engine's frame_signs is one K5 launch, equal bit for bit to the
    same engine's use_kernel=False frame_signs on the same draws; a whole
    call launches K5 once per frame_signs call."""
    nq, S = 10, 4
    engines = [KickedIsingEngine(configurable_device(nq, seed=0), nq=nq,
                                 steps=S, device=cuda_device, n_traj=8,
                                 shots=None, use_kernel=k)
               for k in (None, False)]
    draws = _k5_draws(S, 4096, nq - 1, cuda_device, seed=1)
    cones = [LightconeIsing(configurable_device(40, seed=0), nq=40, steps=6,
                            device=cuda_device, n_traj=8, t_chunk=4,
                            shots=None, use_kernel=k) for k in (None, False)]
    tw = cones[0].window_tables(11)
    lc_draws = _k5_draws(6, 512, len(tw["bonds"]), cuda_device, seed=2)
    for (kernel, plain), args in ((engines, (draws,)),
                                  (cones, (lc_draws, tw))):
        before = kfr.propagate_frames.launches
        got = kernel.frame_signs(*args)
        assert kfr.propagate_frames.launches == before + 1
        want = plain.frame_signs(*args)
        torch.cuda.synchronize()
        assert kfr.propagate_frames.launches == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w)

    calls = {"n": 0}

    def counted(fn):
        def wrapped(*a, **kw):
            calls["n"] += 1
            return fn(*a, **kw)
        return wrapped

    J = np.array([0.2, 0.45, 0.3], np.float32)
    for eng, run in ((engines[0], lambda: engines[0].generate(J, seed=3)),
                     (cones[0], lambda: cones[0].generate_stepwise(
                         J, qubits=(0, 11, 20), seed=3))):
        eng.frame_signs = counted(eng.frame_signs)
        calls["n"] = 0
        before = kfr.propagate_frames.launches
        run()
        assert calls["n"] > 0
        assert kfr.propagate_frames.launches - before == calls["n"]


def test_frames_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    bonds = _chain_bonds(6)
    good = _k5_draws(2, 33, len(bonds), cuda_device, seed=0)
    with pytest.raises(TypeError, match="int32"):
        kfr.propagate_frames(good.long(), bonds, 6)
    with pytest.raises(ValueError, match="contiguous"):
        kfr.propagate_frames(good.transpose(0, 1), bonds, 6)
    with pytest.raises(ValueError, match="shape"):
        kfr.propagate_frames(good[..., :1], bonds, 6)
    with pytest.raises(ValueError, match="shape"):
        kfr.propagate_frames(good, bonds[:-1], 6)
    with pytest.raises(ValueError, match="nq"):
        kfr.propagate_frames(good[:, :, :1].contiguous(), [(0, 31)], 32)
    with pytest.raises(ValueError, match="leaves"):
        kfr.propagate_frames(good, bonds[:-1] + [(5, 6)], 6)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(good.numel() + 1, dtype=torch.int32,
                           device=cuda_device)
        kfr.propagate_frames(flat[1:].view(good.shape), bonds, 6)


def test_density_engines_refuse_tf32(cuda_device):
    """The exact path's superop products run at IEEE f32 (complex64 GEMMs
    follow ``allow_tf32`` too): with TF32 on, the dm pipeline and the
    gather engine raise rather than round."""
    from mlqem_tpu_torch import Circuit, NoisyEstimator, PauliSum

    pipe = IsingLabelPipeline(configurable_device(5, seed=0), nq=5, steps=2,
                              device=cuda_device, shots=None)
    est = NoisyEstimator(configurable_device(3, seed=0), device=cuda_device)
    qc = Circuit(3).h(0).cx(0, 1).rx(0.3, 2)
    J = np.array([0.2, 0.4])
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="TF32"):
            pipe.generate(J)
        with pytest.raises(RuntimeError, match="TF32"):
            est.run(qc, PauliSum("XZY"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    _, noisy = pipe.generate(J)
    assert np.isfinite(noisy).all()


def test_density_pipeline_card_matches_cpu(cuda_device):
    """method="density_matrix" with shots=None: the card's labels equal
    the CPU's to 1e-5 (no draws on this path)."""
    kw = dict(nq=6, steps=3, shots=None)
    J = np.random.default_rng(0).uniform(0.05, 0.6, size=16)
    got = IsingLabelPipeline(configurable_device(6, seed=0),
                             device=cuda_device, **kw).generate(J)
    want = IsingLabelPipeline(configurable_device(6, seed=0), device="cpu",
                              **kw).generate(J)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 1e-5


@pytest.mark.parametrize("fuse,pair4", [(False, False), (True, False),
                                        (True, True)])
def test_density_engine_card_matches_cpu(fuse, pair4, cuda_device):
    """run_density_static's three plans on the card against the CPU."""
    from mlqem_tpu_torch.device.noise import NoiseModel, compile_noise_table
    from mlqem_tpu_torch.ops.density_static import run_density_static

    t = make_ising_template(7, 2, "Z", 0.25, h=1.0)
    ct = t.bind_host(np.zeros(t.num_parameters, np.float32))
    keys, table = compile_noise_table(ct, NoiseModel.from_device(
        configurable_device(7, seed=0)))
    params = np.random.default_rng(1).uniform(
        -1, 1, size=(5,) + ct.params.shape).astype(np.float32)
    got = run_density_static(ct, torch.as_tensor(params, device=cuda_device),
                             keys, table, fuse=fuse, pair4=pair4)
    want = run_density_static(ct, torch.as_tensor(params), keys, table)
    assert (got.cpu() - want).abs().max().item() <= 1e-6


# -- the learning stack (plain torch on the card; no kernel of its own) -------
def _gnn_batch(device, n=8, N=12, F=22, seed=0):
    from mlqem_tpu_torch.models.train import gnn_inputs

    rng = np.random.default_rng(seed)
    nv = rng.integers(4, N + 1, size=n)
    nm = np.arange(N)[None, :] < nv[:, None]
    ei = np.zeros((n, 2, 2 * N), np.int32)
    em = np.zeros((n, 2 * N), bool)
    for b, k in enumerate(nv):
        ei[b, :, :2 * k - 1] = [list(range(k - 1)) + list(range(k)),
                                list(range(1, k)) + list(range(k))]
        em[b, :2 * k - 1] = True
    data = {"x": rng.normal(size=(n, N, F)) * nm[..., None],
            "edge_index": ei, "edge_mask": em, "node_mask": nm,
            "noisy": rng.uniform(-1, 1, size=(n, 1)),
            "observable": rng.normal(size=(n, 17)),
            "circuit_depth": rng.uniform(1, 9, size=n)}
    batch = {k: torch.as_tensor(v.astype(np.float32) if v.dtype == np.float64
                                else v, device=device)
             for k, v in data.items()}
    y = torch.as_tensor(rng.uniform(-1, 1, size=(n, 1)).astype(np.float32),
                        device=device)
    return gnn_inputs(batch), y


def test_gnn_forward_and_adam_step_card_match_cpu(cuda_device):
    """The paper's GNN (hidden 15, heads 5/3): eval forward on the card vs
    the CPU ≤ 1e-5; one Adam step with dropout off: gradients ≤ 1e-5,
    running statistics and every parameter element whose gradient is at
    least 1e-6 ≤ 1e-5, the rest within Adam's step bound (2·lr)."""
    import copy

    from mlqem_tpu_torch.models.gnn import ExpValCircuitGraphModel3
    from mlqem_tpu_torch.models.mlp import Dropout, init_params
    from mlqem_tpu_torch.models.train import train_step

    cpu = ExpValCircuitGraphModel3(15, 1, num_node_features=22)
    init_params(cpu, torch.Generator().manual_seed(0))
    for m in cpu.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    card = copy.deepcopy(cpu).to(cuda_device)
    (args_c, y_c), (args_g, y_g) = (_gnn_batch("cpu"),
                                    _gnn_batch(cuda_device))
    with torch.no_grad():
        err = (card.eval()(*args_g).cpu() - cpu.eval()(*args_c)).abs().max()
    assert err.item() <= 1e-5
    for model, args, y in ((cpu, args_c, y_c), (card, args_g, y_g)):
        train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3),
                   args, y)
    for (k, p), q in zip(cpu.named_parameters(), card.parameters()):
        g = q.grad.cpu()
        assert (g - p.grad).abs().max().item() <= 1e-5, k
        d = (q.detach().cpu() - p.detach()).abs()
        tight = torch.maximum(g.abs(), p.grad.abs()) >= 1e-6
        assert d[tight].max().item() <= 1e-5 if tight.any() else True, k
        assert d.max().item() <= 2e-3, k
    for (k, b), c in zip(cpu.named_buffers(), card.buffers()):
        assert (c.cpu() - b).abs().max().item() <= 1e-5, k


def test_forest_and_learning_card_match_cpu(cuda_device):
    """The forest's predict on the card equals the same forest on the CPU
    (≤ 1e-6), and learning(NoisyEstimator) with it as ModelProcessor equals
    its predict on the processor's features."""
    from mlqem_tpu_torch import (Circuit, NoisyEstimator, PauliSum,
                                 RandomForestRegressor, get_device, learning)
    from mlqem_tpu_torch.data.encoders import encode_data, encode_pauli_sum_op
    from mlqem_tpu_torch.mitigation.learning import ModelProcessor

    rng = np.random.default_rng(0)
    dev = get_device("fake_lima")
    X = rng.uniform(-1, 1, size=(64, 72)).astype(np.float32)
    y = np.tanh(X[:, 54] + X[:, 3]).astype(np.float32)
    rf = RandomForestRegressor(20, random_state=0, device=cuda_device)
    rf.fit(X, y)
    rf_cpu = RandomForestRegressor(20, device="cpu").set_stacked(
        *[t.cpu().numpy() for t in rf._stacked], rf._depth)
    rf_cpu._single_output = True
    assert np.abs(rf.predict(X) - rf_cpu.predict(X)).max() <= 1e-6
    qc = Circuit(4).h(0).cx(0, 1).rx(0.4, 2).cx(2, 3)
    res = learning(NoisyEstimator, ModelProcessor(rf, dev, skip_transpile=True)
                   )(dev, device=cuda_device).run(qc, PauliSum("ZIXI")
                                                  ).result()
    Xq, _ = encode_data([qc], dev.properties(), [[0.0]],
                        [[res.metadata[0]["original_value"]]], 1,
                        meas_bases=encode_pauli_sum_op("ZIXI"))
    assert abs(res.values[0] - rf_cpu.predict(Xq)[0]) <= 1e-6


def test_pauli_propagation_card_matches_cpu(cuda_device):
    """The sparse Pauli-propagation engine at nq 40 (two words), both
    sides on the same host-rounded angles and damping: without discards
    ≤ 1e-6; at a K that truncates, the same kept terms (≤ 1e-5)."""
    from mlqem_tpu_torch import PauliPropagatorIsing

    dev = configurable_device(40, seed=0)
    J = np.array([0.1, 0.35], np.float32)
    for K, tol in ((1 << 16, 1e-6), (512, 1e-5)):
        for noise, nf in ((False, 1), (True, 1), (True, 3)):
            out = {}
            for d in ("cpu", cuda_device):
                pp = PauliPropagatorIsing(dev, nq=40, steps=3, dt=0.5,
                                          h=0.66 * np.pi, max_terms=K,
                                          noise=noise, device=d)
                out[str(d)] = pp.generate_stepwise(J, nf, (0, 31, 32, 39))
            (v, e), (cv, ce) = out["cpu"], out[str(cuda_device)]
            if K == 1 << 16:
                assert float(e.max()) == float(ce.max()) == 0.0
            assert np.abs(v - cv).max() <= tol
            assert np.abs(e - ce).max() <= tol


def test_tableau_card_matches_cpu(cuda_device):
    from mlqem_tpu_torch.circuits.families import generate_composed_clifford
    from mlqem_tpu_torch.circuits.observables import single_z
    from mlqem_tpu_torch.ops.stabilizer import batch_expectations

    circuits = [generate_composed_clifford(5, 40, 4, seed=s)
                for s in range(6)]
    for q in (0, 77, 199):
        obs = single_z(q, 200)
        np.testing.assert_array_equal(
            batch_expectations(circuits, obs, device=cuda_device),
            batch_expectations(circuits, obs, device="cpu"))


def test_one_rank_mesh_on_the_card_matches_unsharded(cuda_device):
    """A one-rank NCCL mesh: both generators' ``generate(mesh=)`` equal
    the unsharded call (K1 and K2 launched on the dp path), and the
    sharded statevector equals ``statevector``."""
    import torch.distributed as dist

    from mlqem_tpu_torch.circuits.circuit import tensorize
    from mlqem_tpu_torch.circuits.families import random_circuit
    from mlqem_tpu_torch.ops.sharded_sv import sharded_statevector_fn
    from mlqem_tpu_torch.ops.statevector import statevector
    from mlqem_tpu_torch.parallel.mesh import make_mesh

    started = not dist.is_initialized()
    try:
        mesh = make_mesh(device="cuda")
        dev = configurable_device(6, seed=0)
        J = np.linspace(0.1, 0.5, 64).astype(np.float32)
        for eng, kernel in (
                (KickedIsingEngine(dev, nq=6, steps=2, dt=0.5, n_traj=8,
                                   shots=None, device=cuda_device),
                 kev.evolve_fused),
                (IsingLabelPipeline(dev, nq=6, steps=2, dt=0.5, shots=None,
                                    method="frame", n_traj=8,
                                    device=cuda_device),
                 fe.evolve_frame_marginals)):
            want = eng.generate(J, seed=3)
            before = kernel.launches
            got = eng.generate(J, seed=3, mesh=mesh)
            assert kernel.launches > before
            for g, w in zip(got, want):
                assert np.abs(g - w).max() <= 1e-6
        qc = random_circuit(12, 6, seed=5)
        ct = tensorize(qc)
        psi = sharded_statevector_fn(qc, mesh, device="cuda")(ct.params)
        ref = statevector(ct, device=cuda_device)
        assert (psi - ref).abs().max().item() <= 1e-5
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
