"""Port vs JAX package: the fused evolution's plain version and the WHT.

The CUDA kernel itself is tested on the card in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlqem_tpu.device.registry import configurable_device as j_configurable
from mlqem_tpu.ops.kicked_ising import KickedIsingEngine as JEngine
from mlqem_tpu.ops.kicked_ising import _bonds as j_bonds
from mlqem_tpu.ops.kicked_ising import wht as j_wht
from mlqem_tpu.ops.pallas.evolve import evolve_fused as j_evolve_fused

from mlqem_tpu_torch.ops.kernels import evolve as kev
from mlqem_tpu_torch.ops.kernels.wht import hadamard_dense
from mlqem_tpu_torch.ops.kicked_ising import _bonds, _sign_tables, wht

from port_fixtures import one_torch_thread  # noqa: F401


def _tables(nq):
    bit_pm, bond_par = _sign_tables(nq)
    return (np.ascontiguousarray(bit_pm.T), np.ascontiguousarray(bond_par.T),
            bond_par.shape[1])


@pytest.mark.parametrize("nq", [2, 5, 10])
def test_sign_tables_match_jax_engine(nq):
    assert _bonds(nq) == j_bonds(nq)
    jeng = JEngine(j_configurable(nq, seed=0), nq=nq, steps=1,
                   use_pallas=False)
    bit_pm, bond_par = _sign_tables(nq)
    assert bit_pm.dtype == bond_par.dtype == np.float32
    np.testing.assert_array_equal(bit_pm, jeng._bit_pm)
    np.testing.assert_array_equal(bond_par, jeng._bond_par)


def _inputs(rng, nq, rows, steps, start):
    bit_pm_t, bond_par_t, nb = _tables(nq)
    dim = 2 ** nq
    if start == "zero":
        re = np.zeros((rows, dim), np.float32)
        re[:, 0] = 1.0
        im = np.zeros((rows, dim), np.float32)
    else:
        re = rng.normal(size=(rows, dim)).astype(np.float32)
        im = rng.normal(size=(rows, dim)).astype(np.float32)
    kick = rng.choice([-1., 1.], size=(rows, steps * nq)).astype(np.float32)
    bond = rng.choice([-1., 1.], size=(rows, steps * nb)).astype(np.float32)
    tj = rng.uniform(-1.2, -0.1, size=(rows, 1)).astype(np.float32)
    return (re, im, kick, bond, tj, bit_pm_t, bond_par_t), nb


@pytest.mark.parametrize("start,atol", [("zero", 1e-5), ("random", 1e-4)])
@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("nq", [4, 6, 8])
def test_reference_matches_jax_evolve_fused(nq, steps, start, atol, rng):
    args, nb = _inputs(rng, nq, rows=5, steps=steps, start=start)
    theta_h = 0.5
    jre, jim = j_evolve_fused(*(jnp.asarray(a) for a in args), theta_h,
                              steps, nq, nb, interpret=True)
    re, im = kev.evolve_fused_reference(
        *(torch.as_tensor(a) for a in args), theta_h, steps, nq, nb)
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), atol=atol,
                               rtol=0)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), atol=atol,
                               rtol=0)
    if start == "zero":   # unitary evolution keeps the norm
        norm = (re ** 2 + im ** 2).sum(-1).numpy()
        np.testing.assert_allclose(norm, 1.0, atol=1e-5)


def test_wht_matches_jax_nq10(rng):
    nq = 10
    st = (rng.normal(size=(3, 2 ** nq)) + 1j * rng.normal(size=(3, 2 ** nq))
          ).astype(np.complex64)
    ref = np.asarray(j_wht(jnp.asarray(st), nq))
    got_re = wht(torch.as_tensor(st.real.copy()), nq).numpy()
    got_im = wht(torch.as_tensor(st.imag.copy()), nq).numpy()
    np.testing.assert_allclose(got_re, ref.real, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_im, ref.imag, atol=1e-6, rtol=0)


@pytest.mark.parametrize("nq", [1, 3, 6])
def test_wht_is_dense_hadamard(nq, rng):
    x = rng.normal(size=(4, 2 ** nq)).astype(np.float32)
    want = x.astype(np.float64) @ hadamard_dense(nq).astype(np.float64)
    got = wht(torch.as_tensor(x), nq).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_cpu_tensors_take_the_plain_version(rng, monkeypatch):
    monkeypatch.setattr(kev.evolve_fused, "launches", 0)
    args, nb = _inputs(rng, 6, rows=4, steps=2, start="zero")
    targs = [torch.as_tensor(a) for a in args]

    def no_build():
        raise AssertionError("a CPU tensor must not reach the kernel")

    monkeypatch.setattr(kev, "load_library", no_build)
    got = kev.evolve_fused(*targs, 0.5, 2, 6, nb)
    want = kev.evolve_fused_reference(*targs, 0.5, 2, 6, nb)
    assert kev.evolve_fused.launches == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_refuses_other_devices(rng):
    args, nb = _inputs(rng, 4, rows=2, steps=1, start="zero")
    targs = [torch.as_tensor(a, device="meta") for a in args]
    with pytest.raises(ValueError, match="cpu or cuda"):
        kev.evolve_fused(*targs, 0.5, 1, 4, nb)
