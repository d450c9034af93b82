"""MLP regressors, and the layers every model of the port is built from.

Counterpart of ``mlqem_tpu/models/mlp.py`` (flax). Architecture parity
with the reference's torch models (``blackwater/library/learning/mlp.py:
18-108``):

* :class:`MLP1` — Linear → ReLU → Linear (the ``h10_mlp`` 58→64→4 model)
* :class:`MLP2` — 2×(Linear+BatchNorm+ReLU+Dropout) with skip connection
* :class:`MLP3` — MLP2 plus a hidden//3 bottleneck head (the paper GNN's
  readout, ``gnn.py:199-204``)

The layers behave as flax's do, so weights carried over from the JAX
package (``convert.state_dict_from_flax``) give the same outputs and a
fresh init trains alike:

* :class:`Dense` — ``nn.Linear`` initialised as flax ``Dense``: LeCun
  normal (truncated) weight, zero bias. Flax infers a layer's input width
  at init; here every constructor takes it.
* :class:`BatchNorm` — flax ``BatchNorm``: running statistics with
  momentum 0.99 and the *biased* batch variance, epsilon 1e-5 (torch's
  ``BatchNorm1d`` keeps the unbiased one).
* :class:`Dropout` — draws its mask from ``generator`` when one is set
  (``models.train.train_model`` sets its own).

Under data parallelism (:func:`shard_batch_layers`) a rank holds a block
of the batch's rows: :class:`BatchNorm` then takes the statistics of the
whole batch (its sums all-reduced over the group, as ``jit`` over a
sharded batch does in flax), and :class:`Dropout` draws the whole batch's
mask and keeps the rank's rows, so a data-parallel step equals the
one-rank step.

Submodules carry flax's names (``Dense_0``, ``BatchNorm_1``, ``MLP3_0``, …)
and :class:`BatchNorm` flax's leaf names (``scale``, ``bias``, ``mean``,
``var``), so a flax variables tree maps onto a ``state_dict`` path by path.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

# stddev of a standard normal truncated to [-2, 2] (flax's variance_scaling)
_TRUNC_STD = 0.87962566103423978


class Dense(nn.Linear):
    """``nn.Linear`` with flax ``Dense``'s init (LeCun normal, zero bias)."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        std = math.sqrt(1.0 / self.in_features) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, std=std, a=-2.0 * std,
                                  b=2.0 * std, generator=generator)
            if self.bias is not None:
                self.bias.zero_()


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis (defaults: momentum 0.99,
    epsilon 1e-5). Training mode normalizes with the batch statistics and
    updates the running ones with the biased batch variance."""

    def __init__(self, features: int, momentum: float = 0.99,
                 epsilon: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        # the process group whose ranks hold the batch's rows, or None
        self.group = None

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            flat = x.reshape(-1, x.shape[-1])
            if self.group is None:
                mean, sq = flat.mean(0), (flat * flat).mean(0)
            else:
                from ..parallel.mesh import all_reduce_sum

                F = flat.shape[-1]
                sums = all_reduce_sum(torch.cat([
                    flat.sum(0), (flat * flat).sum(0),
                    flat.new_full((1,), flat.shape[0])]), self.group)
                mean, sq = sums[:F] / sums[-1], sums[F:2 * F] / sums[-1]
            # flax's fast variance: E[x²] − E[x]², clipped at 0
            var = torch.clamp(sq - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_(
                    (1.0 - self.momentum) * mean)
                self.var.mul_(self.momentum).add_((1.0 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + self.epsilon) * self.scale) \
            + self.bias


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in training mode, zero each element with
    probability ``p`` and scale the rest by 1/(1−p); the mask comes from
    ``generator`` (torch's default generator when it is None)."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None
        # (the whole batch's rows, this rank's row indices), or None
        self.rows: Optional[Tuple[int, torch.Tensor]] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.p >= 1.0:
            return torch.zeros_like(x)
        if self.rows is None:
            keep = torch.rand(x.shape, device=x.device,
                              generator=self.generator) >= self.p
        else:
            n, rows = self.rows
            keep = torch.rand((n,) + x.shape[1:], device=x.device,
                              generator=self.generator)[rows] >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


def shard_batch_layers(model: nn.Module, group, n: int,
                       rows: torch.Tensor) -> nn.Module:
    """Make ``model``'s :class:`BatchNorm` and :class:`Dropout` layers see
    the whole batch of ``n`` rows, of which this rank holds ``rows`` (a
    batch-first model): the statistics are all-reduced over ``group`` and
    each dropout mask is drawn for all n rows. ``group=None`` undoes it."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group
        elif isinstance(m, Dropout):
            m.rows = None if group is None else (n, rows)
    return model


def init_params(model: nn.Module, generator: Optional[torch.Generator] = None
                ) -> nn.Module:
    """Re-initialise every :class:`Dense` and :class:`BatchNorm` of
    ``model`` as flax's ``init`` does, drawing from ``generator``."""
    for m in model.modules():
        if isinstance(m, (Dense, BatchNorm)):
            m.reset_parameters(generator)
    return model


class MLP1(nn.Module):
    def __init__(self, hidden_size: int, output_size: int, *,
                 input_size: int):
        super().__init__()
        self.Dense_0 = Dense(input_size, hidden_size)
        self.Dense_1 = Dense(hidden_size, output_size)

    def forward(self, x):
        return self.Dense_1(torch.relu(self.Dense_0(x)))


class MLP2(nn.Module):
    def __init__(self, hidden_size: int, output_size: int,
                 dropout_rate: float = 0.5, *, input_size: int):
        super().__init__()
        self.Dense_0 = Dense(input_size, hidden_size)
        self.BatchNorm_0 = BatchNorm(hidden_size)
        self.Dense_1 = Dense(hidden_size, hidden_size)
        self.BatchNorm_1 = BatchNorm(hidden_size)
        self.Dense_2 = Dense(hidden_size, output_size)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x):
        x1 = self.dropout(torch.relu(self.BatchNorm_0(self.Dense_0(x))))
        x2 = self.dropout(torch.relu(self.BatchNorm_1(self.Dense_1(x1))))
        x3 = x1 + x2  # skip connection (mlp.py:61)
        return self.Dense_2(x3)


class MLP3(nn.Module):
    def __init__(self, hidden_size: int, output_size: int,
                 dropout_rate: float = 0.3, *, input_size: int):
        super().__init__()
        self.Dense_0 = Dense(input_size, hidden_size)
        self.BatchNorm_0 = BatchNorm(hidden_size)
        self.Dense_1 = Dense(hidden_size, hidden_size)
        self.BatchNorm_1 = BatchNorm(hidden_size)
        self.Dense_2 = Dense(hidden_size, hidden_size // 3)
        self.Dense_3 = Dense(hidden_size // 3, output_size)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x):
        x1 = self.dropout(torch.relu(self.BatchNorm_0(self.Dense_0(x))))
        x2 = self.dropout(torch.relu(self.BatchNorm_1(self.Dense_1(x1))))
        x3 = x1 + x2
        x4 = self.dropout(torch.relu(self.Dense_2(x3)))
        return self.Dense_3(x4)
