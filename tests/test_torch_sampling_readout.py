"""Port vs JAX package: small categorical sampler and readout confusion."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlqem_tpu.ops.density import apply_readout_confusion as j_readout

from mlqem_tpu_torch import NoiseModel, configurable_device
from mlqem_tpu_torch.ops.density import apply_readout_confusion
from mlqem_tpu_torch.ops.sampling import sample_small_categorical
from mlqem_tpu_torch.ops.trajectory import pauli_channel_probs


def _bond_channel_probs():
    """A real 16-way bond channel, made noisier so every Pauli shows up."""
    nm = NoiseModel.from_device(configurable_device(4, seed=0), scale=20.0)
    return pauli_channel_probs(nm.channel_for("cx", (0, 1)))


def test_sample_small_categorical_frequencies():
    p = _bond_channel_probs()
    assert p.shape == (16,) and (p > 0).sum() >= 10
    n = 400_000
    gen = torch.Generator().manual_seed(3)
    draws = sample_small_categorical(torch.as_tensor(p), (n,), gen)
    assert draws.dtype == torch.int32 and draws.shape == (n,)
    counts = np.bincount(draws.numpy(), minlength=16)
    assert counts.shape == (16,)
    sigma = np.sqrt(n * p * (1 - p))
    assert np.all(np.abs(counts - n * p) <= 5 * sigma + 1e-9), (counts,
                                                                 n * p)


def test_sample_small_categorical_broadcasts_per_row():
    """Per-bond tables [nb, 1, 16] against draws [S, rows, nb, 2]: each
    bond column follows its own table."""
    p0 = np.eye(1, 16, 3)[0]
    p1 = np.eye(1, 16, 11)[0]
    probs = torch.as_tensor(np.stack([p0, p1])[:, None, :])
    gen = torch.Generator().manual_seed(0)
    draws = sample_small_categorical(probs, (2, 50, 2, 2), gen)
    assert torch.all(draws[:, :, 0] == 3) and torch.all(draws[:, :, 1] == 11)


def test_sample_small_categorical_is_seeded():
    p = torch.as_tensor(_bond_channel_probs())
    a = sample_small_categorical(p, (1000,), torch.Generator().manual_seed(7))
    b = sample_small_categorical(p, (1000,), torch.Generator().manual_seed(7))
    assert torch.equal(a, b)


@pytest.mark.parametrize("nq", [4, 10])
def test_apply_readout_confusion_matches_jax(nq, rng):
    dim = 2 ** nq
    probs = rng.random((3, dim)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    eps = rng.uniform(0.005, 0.05, size=(nq, 2))
    conf = np.stack([[[1 - e0, e1], [e0, 1 - e1]] for e0, e1 in eps]
                    ).astype(np.float32)
    ref = np.asarray(j_readout(jnp.asarray(probs), jnp.asarray(conf), nq))
    got = apply_readout_confusion(torch.as_tensor(probs),
                                  torch.as_tensor(conf), nq).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
