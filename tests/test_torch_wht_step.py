"""Port vs JAX package: K4's and K3's plain versions, and the matmul WHTs.

The JAX functions run their Pallas kernels in interpret mode on the CPU;
the port's wrappers run their plain versions for CPU tensors. The CUDA
kernels are held to these plain versions on the card
(``test_torch_cuda.py``, ``chip_smoke.py`` phase 9).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlqem_tpu.ops.kicked_ising import wht as j_wht
from mlqem_tpu.ops.kicked_ising import wht_mm as j_wht_mm
from mlqem_tpu.ops.pallas.fused_step import \
    fused_trotter_step as j_fused_trotter_step
from mlqem_tpu.ops.pallas.fused_step import wht_radix as j_wht_radix
from mlqem_tpu.ops.pallas.wht import wht_fused as j_wht_fused
from mlqem_tpu.ops.pallas.wht import wht_pallas_planes as j_wht_planes

from mlqem_tpu_torch.ops.kernels import fused_step as kfs
from mlqem_tpu_torch.ops.kernels import wht as kwht
from mlqem_tpu_torch.ops.kicked_ising import _sign_tables, wht_mm

from port_fixtures import one_torch_thread  # noqa: F401


def _planes(rng, rows, nq):
    return (rng.normal(size=(rows, 2 ** nq)).astype(np.float32),
            rng.normal(size=(rows, 2 ** nq)).astype(np.float32))


@pytest.mark.parametrize("nq,rows", [(1, 3), (5, 1), (5, 7), (8, 13)])
def test_wht_planes_matches_jax_interpret(nq, rows, rng):
    re, im = _planes(rng, rows, nq)
    jre, jim = j_wht_planes(jnp.asarray(re), jnp.asarray(im), nq,
                            block_rows=4, interpret=True)
    t_re, t_im = torch.as_tensor(re.copy()), torch.as_tensor(im.copy())
    got_re, got_im = kwht.wht_planes(t_re, t_im, nq)
    assert got_re is t_re and got_im is t_im        # in place
    np.testing.assert_allclose(got_re.numpy(), np.asarray(jre), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(got_im.numpy(), np.asarray(jim), atol=2e-5,
                               rtol=0)


def test_wht_fused_matches_jax(rng):
    st = (rng.normal(size=(2, 3, 64)) + 1j * rng.normal(size=(2, 3, 64))
          ).astype(np.complex64)
    want = np.asarray(j_wht_fused(jnp.asarray(st), 6, interpret=True))
    got = kwht.wht_fused(torch.as_tensor(st), 6)
    assert got.dtype == torch.complex64 and got.shape == st.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_wht_planes_cpu_takes_the_plain_version(rng, monkeypatch):
    monkeypatch.setattr(kwht.wht_planes, "launches", 0)

    def no_build():
        raise AssertionError("a CPU tensor must not reach the kernel")

    monkeypatch.setattr(kwht, "load_library", no_build)
    re, im = _planes(rng, 4, 6)
    want = kwht.wht_planes_reference(torch.as_tensor(re),
                                     torch.as_tensor(im), 6)
    got = kwht.wht_planes(torch.as_tensor(re), torch.as_tensor(im), 6)
    assert kwht.wht_planes.launches == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="cpu or cuda"):
        kwht.wht_planes(torch.zeros((1, 4), device="meta"),
                        torch.zeros((1, 4), device="meta"), 2)


def _step_inputs(rng, rows, nq):
    bit_pm, bond_par = _sign_tables(nq)
    nb = bond_par.shape[1]
    re, im = _planes(rng, rows, nq)
    norm = np.sqrt((re ** 2 + im ** 2).sum(axis=1, keepdims=True))
    return [re / norm, im / norm,
            rng.choice([-1., 1.], size=(rows, nq)).astype(np.float32),
            rng.choice([-1., 1.], size=(rows, nb)).astype(np.float32),
            rng.uniform(-1.2, -0.1, size=(rows, 1)).astype(np.float32),
            bit_pm, bond_par]


@pytest.mark.parametrize("nq,rows", [(5, 3), (8, 5)])
def test_fused_trotter_step_matches_jax_interpret(nq, rows, rng):
    args = _step_inputs(rng, rows, nq)
    theta_h = 0.9
    jre, jim = j_fused_trotter_step(*(jnp.asarray(a) for a in args), theta_h,
                                    A=2 ** nq // min(2 ** nq, 128),
                                    L=min(2 ** nq, 128), block_rows=8,
                                    interpret=True)
    re, im = kfs.fused_trotter_step(*(torch.as_tensor(a) for a in args),
                                    theta_h)
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), atol=1e-5,
                               rtol=0)
    # the step is unitary
    np.testing.assert_allclose((re ** 2 + im ** 2).sum(-1).numpy(), 1.0,
                               atol=1e-5)


def test_fused_trotter_step_cpu_takes_the_plain_version(rng, monkeypatch):
    monkeypatch.setattr(kfs.fused_trotter_step, "launches", 0)

    def no_build():
        raise AssertionError("a CPU tensor must not reach the kernel")

    monkeypatch.setattr(kfs, "load_library", no_build)
    args = [torch.as_tensor(a) for a in _step_inputs(rng, 4, 6)]
    got = kfs.fused_trotter_step(*args, 0.5)
    want = kfs.fused_trotter_step_reference(*args, 0.5)
    assert kfs.fused_trotter_step.launches == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("nq", [4, 8, 10])
def test_wht_radix_matches_jax(nq, rng):
    st = (rng.normal(size=(5, 2 ** nq)) + 1j * rng.normal(size=(5, 2 ** nq))
          ).astype(np.complex64)
    want = np.asarray(j_wht_radix(jnp.asarray(st), nq))
    got = kfs.wht_radix(torch.as_tensor(st), nq)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_wht(
        jnp.asarray(st), nq)), atol=2e-5, rtol=0)


@pytest.mark.parametrize("nq,radix", [(6, 7), (10, 3), (14, 7)])
def test_wht_mm_matches_jax(nq, radix, rng):
    st = (rng.normal(size=(2, 2 ** nq)) + 1j * rng.normal(size=(2, 2 ** nq))
          ).astype(np.complex64)
    want = np.asarray(j_wht_mm(jnp.asarray(st), nq, radix))
    got = wht_mm(torch.as_tensor(st), nq, radix)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    # a second reference for K4's plain version
    re = torch.as_tensor(st.real.copy())
    np.testing.assert_allclose(kwht.wht(re, nq).numpy(), got.real.numpy(),
                               atol=2e-5, rtol=0)


def test_wht_mm_rejects_too_many_slabs():
    with pytest.raises(ValueError, match="nq <= 8 at radix=1"):
        wht_mm(torch.zeros((1, 2 ** 9)), 9, radix=1)
    with pytest.raises(ValueError, match="nq <= 8 at radix=1"):
        j_wht_mm(jnp.zeros((1, 2 ** 9)), 9, radix=1)
