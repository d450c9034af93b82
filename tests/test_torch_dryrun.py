"""The port's ``dryrun_multichip`` on four gloo ranks: the data-parallel
GNN step against the one-rank step, from starting weights carried over
from flax.

One ``spawn`` (the module fixture's ``dryrun_multichip(4, "cpu")``)
serves every case.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mlqem_tpu.models.gnn import ExpValCircuitGraphModel3 as JaxModel3
from mlqem_tpu.models.gnn import edge_index_to_adj as jax_adj

from mlqem_tpu_torch.convert import state_dict_from_flax
from mlqem_tpu_torch.entry import (dp_train_step, dryrun_batch,
                                   dryrun_model, dryrun_multichip)
from mlqem_tpu_torch.models.gnn import edge_index_to_adj

from port_fixtures import bounded_rank_wait, one_torch_thread  # noqa: F401

N_DEV = 4
LR = 1e-3


def _jax_init(batch):
    """The JAX dry run's init (``__graft_entry__.py``: PRNGKey(0)), under
    ``jax.jit`` (one compile instead of op-by-op dispatch)."""
    B, N = batch["x"].shape[:2]
    model = JaxModel3(hidden_channels=5, exp_value_size=4)

    @jax.jit
    def init(key, *args):
        return model.init({"params": key, "dropout": key}, *args,
                          train=False)

    variables = init(jax.random.PRNGKey(0), jnp.asarray(batch["noisy"]),
                     jnp.asarray(batch["observable"]),
                     jnp.asarray(batch["depth"]), jnp.asarray(batch["x"]),
                     jnp.zeros((B, N, N)), jnp.asarray(batch["node_mask"]))
    return model, jax.tree_util.tree_map(np.asarray, variables)


@pytest.fixture(scope="module")
def flax_start():
    batch = dryrun_batch(N_DEV)
    model, variables = _jax_init(batch)
    return batch, model, variables, state_dict_from_flax(variables)


@pytest.fixture(scope="module")
def report(flax_start):
    return dryrun_multichip(N_DEV, device="cpu", state_dict=flax_start[3])


def test_dryrun_multichip_on_cpu_ranks(report):
    """Each part within its bound (the dry run raises otherwise)."""
    err = report["errors"]
    assert np.isfinite(report["loss"])
    assert err["sv_z"] <= 1e-4 and err["sv_state"] <= 1e-5
    assert err["labels"] <= 1e-6
    assert report["sp"] == 4
    for runs in report["labels"]:
        for ideal, noisy in runs:
            assert ideal.shape == noisy.shape == (2 * N_DEV, 4)
            assert np.isfinite(noisy).all()


def test_dp_step_equals_one_rank_step(report, flax_start):
    """Four ranks (BatchNorm statistics and dropout masks of the whole
    batch, gradients averaged) against one rank on the whole batch, here:
    gradients, statistics and loss ≤ 1e-5; the weights ≤ 1e-5 where
    |g| > 1e-6, and elsewhere, where Adam's first step lr·g/(|g| + 1e-8)
    is decided by rounding, within 2·lr."""
    model = dryrun_model()
    model.load_state_dict(flax_start[3])
    loss, grads = dp_train_step(model, dryrun_batch(N_DEV),
                                learning_rate=LR)
    assert abs(report["loss"] - loss) <= 1e-5
    params = dict(model.named_parameters())
    for name, g in grads.items():
        np.testing.assert_allclose(report["grads"][name], g, atol=1e-5,
                                   rtol=0)
    moved = 0
    for name, v in model.state_dict().items():
        got, want = report["state"][name], v.numpy()
        if name not in params:          # BatchNorm's running statistics
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
            continue
        big = np.abs(grads[name]) > 1e-6
        np.testing.assert_allclose(got[big], want[big], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got[~big], want[~big], atol=2 * LR,
                                   rtol=0)
        moved += int(big.sum())
    assert moved > 1000


def test_start_weights_carried_from_flax(flax_start):
    """The converted flax weights give JAX's eval-mode forward."""
    batch, jmodel, variables, state = flax_start
    N = batch["x"].shape[1]
    want = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
        variables, batch["noisy"], batch["observable"], batch["depth"],
        batch["x"], jax_adj(batch["edge_index"], batch["edge_mask"], N),
        batch["node_mask"])
    model = dryrun_model()
    model.load_state_dict(state)
    model.eval()
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        got = model(b["noisy"], b["observable"], b["depth"], b["x"],
                    edge_index_to_adj(b["edge_index"], b["edge_mask"], N),
                    b["node_mask"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_dryrun_needs_a_card_per_rank():
    """``device="cuda"`` never moves to the CPU: without the cards it
    refuses."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("this host has two cards")
    with pytest.raises(ValueError, match="cards"):
        dryrun_multichip(2, device="cuda")
