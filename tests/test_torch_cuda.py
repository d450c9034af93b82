"""The port's CUDA kernel on the card (marked ``cuda``; skips without one).

This file imports neither JAX nor ``mlqem_tpu``, so it also runs where only
PyTorch is installed::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from mlqem_tpu_torch import KickedIsingEngine, configurable_device
from mlqem_tpu_torch.ops.kernels import evolve as kev
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
