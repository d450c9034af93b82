"""The flagship model's forward step, ready to call.

Counterpart of ``__graft_entry__.py::entry``: the paper's GNN
(``ExpValCircuitGraphModel3``, hidden 15) on a padded circuit-graph batch
(B 8, N 32, F 22, K 4) with the same inputs, drawn from
``np.random.default_rng(0)`` in the same order. The weights are a
``state_dict`` argument of ``fn``, as the flax ``variables`` are there, so
a state converted from flax (``convert.state_dict_from_flax``) runs in
their place.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple, Union

import numpy as np
import torch

from .models.gnn import ExpValCircuitGraphModel3
from .models.mlp import init_params


def entry(device: Union[str, torch.device] = "cuda"
          ) -> Tuple[Callable, tuple]:
    """(fn, example_args): ``fn(state_dict, noisy, observable, depth, x,
    adj, node_mask)`` is the model's eval-mode forward [B, K] on
    ``device``; ``example_args`` are the model's own weights (initialised
    from seed 0) and the inputs, on ``device``."""
    device = torch.device(device)
    B, N, F, K = 8, 32, 22, 4
    model = ExpValCircuitGraphModel3(hidden_channels=15, exp_value_size=K,
                                     num_node_features=F)
    init_params(model, torch.Generator().manual_seed(0))
    model.to(device).eval()
    rng = np.random.default_rng(0)

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    noisy = dev(rng.uniform(-1, 1, (B, K)))
    observable = dev(rng.normal(size=(B, 1, 17)))
    depth = dev(rng.uniform(1, 9, (B,)))
    x = dev(rng.normal(size=(B, N, F)))
    adj = torch.zeros((B, N, N), dtype=torch.float32, device=device)
    idx = torch.arange(N - 1, device=device)
    adj[:, idx + 1, idx] = 1.0
    node_mask = torch.ones((B, N), dtype=torch.bool, device=device)
    state: Dict[str, torch.Tensor] = dict(model.state_dict())

    def fn(state_dict, noisy, observable, depth, x, adj, node_mask):
        with torch.no_grad():
            return torch.func.functional_call(
                model, state_dict,
                (noisy, observable, depth, x, adj, node_mask))

    return fn, (state, noisy, observable, depth, x, adj, node_mask)
