"""The port's CUDA kernels on the card (marked ``cuda``; skips without one).

This file imports neither JAX nor ``mlqem_tpu``, so it also runs where only
PyTorch is installed::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from mlqem_tpu_torch import (IsingLabelPipeline, KickedIsingEngine,
                             LightconeIsing, configurable_device)
from mlqem_tpu_torch.ops.kernels import evolve as kev
from mlqem_tpu_torch.ops.kernels import frame_evolve as fe
from mlqem_tpu_torch.ops.kernels import fused_step as kfs
from mlqem_tpu_torch.ops.kernels import wht as kwht
from mlqem_tpu_torch.ops.kicked_ising import _sign_tables

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


@pytest.mark.parametrize("nq,rows", [(1, 3), (2, 5), (5, 1000), (10, 4099),
                                     (13, 17)])
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
        fe.evolve_frame_marginals(theta, plan, 14)
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


@pytest.mark.parametrize("nq,rows", [(1, 2), (3, 5), (7, 33), (10, 1000),
                                     (13, 17), (14, 3)])
def test_step_kernel_matches_reference(nq, rows, cuda_device):
    args = _step_inputs(nq, rows, cuda_device)
    before = kfs.fused_trotter_step.launches
    got = kfs.fused_trotter_step(*args, 0.9)
    want = kfs.fused_trotter_step_reference(*args, 0.9)
    torch.cuda.synchronize()
    assert kfs.fused_trotter_step.launches == before + 1
    for g_, w_ in zip(got, want):
        assert (g_ - w_).abs().max().item() <= 1e-5


def test_step_kernel_poisons_output_on_non_sign_tables(cuda_device):
    args = _step_inputs(6, 8, cuda_device)
    args[6] = args[6] * 0.5
    re, im = kfs.fused_trotter_step(*args, 0.5)
    assert torch.isnan(re).all() and torch.isnan(im).all()


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
    with pytest.raises(ValueError, match="nq"):
        kfs.fused_trotter_step(*_step_inputs(15, 1, cuda_device), 0.5)


@pytest.mark.parametrize("nq,steps", [(12, 3), (20, 7)])
def test_lightcone_kernel_matches_plain_path(nq, steps, cuda_device):
    """w=7 runs through K3, w=15 through K4; the same draws on both."""
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
    assert launches[0] == ((calls, 0) if 2 * steps + 1 <= kfs.MAX_NQ
                           else (0, 2 * calls))
    assert launches[1] == (0, 0)
    for got, want in zip(*out):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
