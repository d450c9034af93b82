"""Training loops: Adam + ReduceLROnPlateau + checkpointing.

Counterpart of ``mlqem_tpu/models/train.py``. The reference's training
harness (``docs/tutorials/__ml_models.py:100-263`` ``train_gnn``;
``h10_mlp.ipynb`` MLP loop): Adam, MSE loss, ReduceLROnPlateau on
validation loss, ``state_dict`` checkpoints, loss-curve history. Here:
``torch.optim.Adam`` (optax's ``adam`` update: eps 1e-8 outside the square
root) with the host-side plateau scheduler writing ``param_group["lr"]``,
the dataset resident on ``device`` for the whole run, and one loss fetch
per epoch. The host draws (train/val split, epoch shuffles) follow the JAX
package's ``numpy.random.default_rng(seed)`` stream, so the same seed
gives the same batches; the weights and dropout masks come from a
``torch.Generator`` seeded with ``seed``.
"""
from __future__ import annotations

import os
import random
from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from .gnn import edge_index_to_adj
from .mlp import Dropout, init_params


def fix_random_seed(seed: int = 0) -> torch.Generator:
    """Full determinism (``mlp.py:112-121`` parity): seeds Python, numpy
    and torch's default generators, and returns a CPU ``torch.Generator``
    seeded with ``seed``."""
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    print(f"random seed fixed to {seed}")
    return torch.Generator().manual_seed(seed)


def save_checkpoint(path: str, state_dict: Dict[str, torch.Tensor],
                    extra: Optional[dict] = None):
    torch.save({"state_dict": state_dict, "extra": extra or {}}, path)


def load_checkpoint(path: str,
                    map_location: Union[str, torch.device, None] = None):
    """(state_dict, extra) saved by :func:`save_checkpoint`."""
    payload = torch.load(path, map_location=map_location, weights_only=True)
    return payload["state_dict"], payload.get("extra", {})


class PlateauScheduler:
    """Host-side ReduceLROnPlateau (torch semantics: factor, patience)."""

    def __init__(self, factor: float = 0.5, patience: int = 15,
                 min_lr: float = 1e-5):
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = np.inf
        self.bad_epochs = 0

    def step(self, val_loss: float, lr: float) -> float:
        if val_loss < self.best - 1e-12:
            self.best = val_loss
            self.bad_epochs = 0
            return lr
        self.bad_epochs += 1
        if self.bad_epochs > self.patience:
            self.bad_epochs = 0
            return max(lr * self.factor, self.min_lr)
        return lr


def _split_train_val(n: int, val_fraction: float, rng: np.random.Generator):
    idx = rng.permutation(n)
    n_val = max(1, int(n * val_fraction)) if val_fraction > 0 else 0
    return idx[n_val:], idx[:n_val]


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
               inputs: Sequence[torch.Tensor], yb: torch.Tensor
               ) -> torch.Tensor:
    """One optimizer step on the MSE loss, the model in training mode
    (batch statistics, dropout); the gradients stay in ``.grad``. Returns
    the batch loss, still on the device.

    Adam's first step moves each element by lr·g/(|g| + 1e-8), so where a
    gradient is within ~100·eps of zero — the attention key biases and the
    biases feeding a BatchNorm, whose exact gradients are zero, and
    data-dependent near-zeros — rounding decides a step of up to lr: two
    f32 implementations agree there only within that bound.
    """
    model.train()
    optimizer.zero_grad(set_to_none=True)
    loss = torch.mean((model(*inputs) - yb) ** 2)
    loss.backward()
    optimizer.step()
    return loss.detach()


def _on_device(data: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in data.items()}


def train_model(model: nn.Module,
                inputs_fn: Callable[[Dict[str, torch.Tensor]], tuple],
                data: Dict[str, np.ndarray], y: np.ndarray,
                num_epochs: int = 100, batch_size: int = 32,
                learning_rate: float = 1e-3, val_fraction: float = 0.1,
                seed: int = 0, plateau: Optional[PlateauScheduler] = None,
                checkpoint_path: Optional[str] = None,
                verbose: bool = False,
                device: Union[str, torch.device] = "cuda"):
    """Generic supervised trainer.

    Args:
        model: module whose forward takes ``*inputs_fn(batch)``; it is
            moved to ``device``, re-initialised from ``seed`` and trained
            in place, and ends holding the best validation weights.
        inputs_fn: maps a dict batch of tensors to the model's arguments.
        data: dict of equal-leading-dim arrays.
        y: targets [B] or [B, K].

    Returns:
        (state_dict, history) — the best validation weights (tensors on
        ``device``) and the train/val loss and lr curves.
    """
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    y = np.asarray(y, np.float32)
    if y.ndim == 1:
        y = y[:, None]
    n = y.shape[0]
    tr_idx, va_idx = _split_train_val(n, val_fraction, rng)
    plateau = plateau or PlateauScheduler()

    # the init draws on the CPU, so a seed gives the same weights anywhere
    init_params(model.cpu(), torch.Generator().manual_seed(seed))
    model.to(device)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = gen
    optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate,
                                 eps=1e-8)

    # The dataset stays on the device for the whole run: batches are
    # gathered there, and the losses are fetched once per epoch.
    data_dev = _on_device(data, device)
    y_dev = torch.as_tensor(y, device=device)

    def batch_of(sel):
        sel = torch.as_tensor(sel, device=device)
        return {k: v[sel] for k, v in data_dev.items()}, y_dev[sel]

    history = {"train_loss": [], "val_loss": [], "lr": []}
    lr = learning_rate
    best_val = np.inf
    best_state = None
    for epoch in range(num_epochs):
        for group in optimizer.param_groups:
            group["lr"] = lr
        order = rng.permutation(tr_idx)
        losses = []
        for s in range(0, len(order), batch_size):
            batch, yb = batch_of(order[s:s + batch_size])
            losses.append(train_step(model, optimizer, inputs_fn(batch), yb))
        losses = torch.stack(losses).cpu().numpy()   # ONE fetch/epoch
        if len(va_idx):
            model.eval()
            val_losses = []
            with torch.no_grad():
                for s in range(0, len(va_idx), batch_size):
                    batch, yb = batch_of(va_idx[s:s + batch_size])
                    val_losses.append(torch.mean(
                        (model(*inputs_fn(batch)) - yb) ** 2))
            val_loss = float(np.mean(torch.stack(val_losses).cpu().numpy()))
        else:
            val_loss = float(np.mean(losses))
        history["train_loss"].append(float(np.mean(losses)))
        history["val_loss"].append(val_loss)
        history["lr"].append(lr)
        lr = plateau.step(val_loss, lr)
        if val_loss < best_val:
            best_val = val_loss
            best_state = {k: v.detach().clone()
                          for k, v in model.state_dict().items()}
        if verbose and epoch % 10 == 0:
            print(f"epoch {epoch}: train {history['train_loss'][-1]:.5f} "
                  f"val {val_loss:.5f} lr {lr:.2e}")

    if best_state is None:
        best_state = {k: v.detach().clone()
                      for k, v in model.state_dict().items()}
    model.load_state_dict(best_state)
    model.eval()
    if checkpoint_path:
        save_checkpoint(checkpoint_path, best_state, {"history": history})
    return best_state, history


# ---------------------------------------------------------------------------
# Task-specific wrappers
# ---------------------------------------------------------------------------
def mlp_inputs(batch: Dict[str, torch.Tensor]):
    return (batch["X"],)


def train_mlp(model, X, y, **kwargs):
    """MLP/flat-feature training (``h10_mlp`` loop shape)."""
    return train_model(model, mlp_inputs, {"X": np.asarray(X, np.float32)},
                       y, **kwargs)


def gnn_inputs(batch: Dict[str, torch.Tensor]):
    x = batch["x"]
    adj = edge_index_to_adj(batch["edge_index"], batch["edge_mask"],
                            x.shape[1])
    return (batch["noisy"], batch["observable"], batch["circuit_depth"], x,
            adj, batch["node_mask"])


def train_gnn(model, dataset_arrays: Dict[str, np.ndarray], y=None,
              **kwargs):
    """GNN training on an :class:`ExpValDataset`-style array dict
    (``__ml_models.py:100-205`` ``train_gnn`` equivalent)."""
    data = dict(dataset_arrays)
    if y is None:
        y = data.pop("y")
    else:
        data.pop("y", None)
    return train_model(model, gnn_inputs, data, y, **kwargs)


def predict(model: nn.Module, state_dict: Optional[Dict[str, Any]],
            inputs_fn, data: Dict[str, np.ndarray], batch_size: int = 256
            ) -> np.ndarray:
    """Eval-mode outputs on ``data`` in batches, on the model's device;
    ``state_dict`` (when not None) is loaded first."""
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model.eval()
    device = next(model.parameters()).device
    n = next(iter(data.values())).shape[0]
    outs = []
    with torch.no_grad():
        for s in range(0, n, batch_size):
            batch = _on_device({k: v[s:s + batch_size]
                                for k, v in data.items()}, device)
            outs.append(model(*inputs_fn(batch)))
    return torch.cat(outs).cpu().numpy()
