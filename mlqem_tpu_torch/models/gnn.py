"""Graph neural networks for circuit graphs (torch, dense adjacency).

Counterpart of ``mlqem_tpu/models/gnn.py``. Rebuilds the reference's PyG
models (``docs/tutorials/gnn.py:70-276``) — TransformerConv → ASAPooling →
TransformerConv → ASAPooling → global_mean_pool → concat(graph, noisy
expvals, depth) → head — as masked dense ops: attention and pooling are
[B, N, N] batched matmuls instead of PyG's sparse scatter kernels. Node
padding is handled with masks throughout.

Model variants and their capacities match the reference:
``ExpValCircuitGraphModel`` (heads 3/2, linear head),
``_2`` (MLP2 head), ``_3`` (heads 5/3, MLP3 head — **the paper's GNN**),
``_4`` (inferior variant kept for parity). Each constructor takes the
input widths flax infers at init (``num_node_features``; the ensemble also
``observable_size``); the noisy-value input is ``exp_value_size`` wide.
Every forward takes ``(exp_value, observable, circuit_depth, x, adj,
node_mask)``; v1-v4 ignore ``observable``. ``module.train()`` /
``module.eval()`` stand for flax's ``train=`` flag.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from .mlp import MLP2, MLP3, Dense, Dropout

_NEG = -1e9


def edge_index_to_adj(edge_index: torch.Tensor, edge_mask: torch.Tensor,
                      num_nodes: int) -> torch.Tensor:
    """[B, 2, E] (+mask) → dense adjacency [B, N, N] with adj[b, dst, src].

    Duplicate edges (the dataset's self-loops) reduce by max, as the JAX
    package's ``.at[...].max``: one ``scatter_reduce_("amax")`` on flat
    indices, which is order-independent.
    """
    src = edge_index[:, 0, :].long()
    dst = edge_index[:, 1, :].long()
    B, E = src.shape
    b_idx = torch.arange(B, device=src.device)[:, None]
    flat = (b_idx * num_nodes + dst) * num_nodes + src
    adj = torch.zeros(B * num_nodes * num_nodes, dtype=torch.float32,
                      device=src.device)
    adj.scatter_reduce_(0, flat.reshape(-1),
                        edge_mask.reshape(-1).to(torch.float32), "amax")
    return adj.reshape(B, num_nodes, num_nodes)


def _masked_softmax(logits: torch.Tensor, mask: torch.Tensor
                    ) -> torch.Tensor:
    """Softmax over the last axis where ``mask``; rows with no True entry
    become all zeros."""
    attn = torch.softmax(torch.where(mask, logits, _NEG), dim=-1)
    return torch.where(mask.any(-1, keepdim=True), attn, 0.0)


class TransformerConvDense(nn.Module):
    """Dense-masked equivalent of PyG ``TransformerConv`` (concat heads).

    out_i = W_root x_i + Σ_j α_ij W_v x_j over incoming edges j→i,
    α = softmax_j(⟨W_q x_i, W_k x_j⟩/√d); output dim = heads·channels.
    """

    def __init__(self, in_channels: int, channels: int, heads: int = 1,
                 dropout: float = 0.0):
        super().__init__()
        self.channels, self.heads = channels, heads
        self.q = Dense(in_channels, heads * channels)
        self.k = Dense(in_channels, heads * channels)
        self.v = Dense(in_channels, heads * channels)
        self.root = Dense(in_channels, heads * channels)
        self.dropout = Dropout(dropout)

    def forward(self, x, adj, node_mask):
        B, N, _ = x.shape
        H, C = self.heads, self.channels
        q = self.q(x).reshape(B, N, H, C)
        k = self.k(x).reshape(B, N, H, C)
        v = self.v(x).reshape(B, N, H, C)
        logits = torch.einsum("bihc,bjhc->bhij", q, k) / math.sqrt(C)
        mask = (adj[:, None, :, :] > 0) & node_mask[:, None, None, :]
        attn = self.dropout(_masked_softmax(logits, mask))
        agg = torch.einsum("bhij,bjhc->bihc", attn, v).reshape(B, N, H * C)
        out = self.root(x) + agg
        return out * node_mask[..., None]


class GCNConvDense(nn.Module):
    """Dense GCN layer: out = D^{-1/2}(A+I)D^{-1/2} X W (Kipf–Welling)."""

    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        self.Dense_0 = Dense(in_channels, channels)

    def forward(self, x, adj, node_mask):
        N = x.shape[1]
        mask = node_mask.to(adj.dtype)
        eye = torch.eye(N, dtype=adj.dtype, device=adj.device)[None]
        a = torch.clamp(adj + eye, 0.0, 1.0)
        a = a * mask[:, None, :] * mask[:, :, None]
        dinv = torch.rsqrt(torch.clamp(a.sum(-1), min=1e-6))
        a_norm = a * dinv[:, :, None] * dinv[:, None, :]
        out = torch.einsum("bij,bjc->bic", a_norm, self.Dense_0(x))
        return out * node_mask[..., None]


class ChebConvDense(nn.Module):
    """Dense Chebyshev spectral conv of order K over the scaled Laplacian."""

    def __init__(self, in_channels: int, channels: int, K: int = 3):
        super().__init__()
        self.K = K
        for i in range(K):
            setattr(self, f"Dense_{i}", Dense(in_channels, channels))

    def forward(self, x, adj, node_mask):
        N = x.shape[1]
        mask = node_mask.to(adj.dtype)
        eye = torch.eye(N, dtype=adj.dtype, device=adj.device)[None]
        a = adj * mask[:, None, :] * mask[:, :, None]
        a = torch.maximum(a, a.transpose(1, 2))      # symmetrize
        dinv = torch.rsqrt(torch.clamp(a.sum(-1), min=1e-6))
        lap = eye - a * dinv[:, :, None] * dinv[:, None, :]
        # scaled: L̃ = L − I  (λ_max ≈ 2 normalization)
        lt = lap - eye
        tx_prev = x
        tx = torch.einsum("bij,bjc->bic", lt, x)
        out = self.Dense_0(tx_prev)
        if self.K > 1:
            out = out + self.Dense_1(tx)
        for i in range(2, self.K):
            tx_next = 2 * torch.einsum("bij,bjc->bic", lt, tx) - tx_prev
            tx_prev, tx = tx, tx_next
            out = out + getattr(self, f"Dense_{i}")(tx)
        return out * node_mask[..., None]


class SAGEConvDense(nn.Module):
    """Dense GraphSAGE (mean aggregator): W1 x + W2 · mean_{j∈N(i)} x_j."""

    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        self.Dense_0 = Dense(in_channels, channels)
        self.Dense_1 = Dense(in_channels, channels)

    def forward(self, x, adj, node_mask):
        a = adj * node_mask[:, None, :]
        deg = torch.clamp(a.sum(-1, keepdim=True), min=1.0)
        neigh = torch.einsum("bij,bjc->bic", a, x) / deg
        out = self.Dense_0(x) + self.Dense_1(neigh)
        return out * node_mask[..., None]


def global_mean_pool(x, node_mask):
    s = (x * node_mask[..., None]).sum(dim=1)
    d = torch.clamp(node_mask.sum(dim=1, keepdim=True), min=1.0)
    return s / d


class NgemEnsembleModel(nn.Module):
    """The ``01_ngem`` ensemble: parallel GCN / Cheb / SAGE stacks pooled
    and merged with the noisy expval, observable encoding, and depth."""

    def __init__(self, hidden_channels: int = 16, exp_value_size: int = 1,
                 dropout: float = 0.2, *, num_node_features: int,
                 observable_size: int):
        super().__init__()
        for conv_cls, name in ((GCNConvDense, "gcn"), (ChebConvDense, "cheb"),
                               (SAGEConvDense, "sage")):
            setattr(self, f"{name}1",
                    conv_cls(num_node_features, hidden_channels))
            setattr(self, f"{name}2",
                    conv_cls(hidden_channels, hidden_channels))
        merge = 3 * hidden_channels + exp_value_size + observable_size + 1
        self.Dense_0 = Dense(merge, hidden_channels * 2)
        self.Dense_1 = Dense(hidden_channels * 2, exp_value_size)
        self.dropout = Dropout(dropout)

    def forward(self, exp_value, observable, circuit_depth, x, adj,
                node_mask):
        B = x.shape[0]
        mask_f = node_mask.to(torch.float32)
        branches = []
        for name in ("gcn", "cheb", "sage"):
            h = torch.relu(getattr(self, f"{name}1")(x, adj, node_mask))
            h = torch.relu(getattr(self, f"{name}2")(h, adj, node_mask))
            branches.append(global_mean_pool(h, mask_f))
        merge = torch.cat(branches + [exp_value.reshape(B, -1),
                                      observable.reshape(B, -1),
                                      circuit_depth.reshape(B, 1)], dim=1)
        h = self.dropout(torch.relu(self.Dense_0(merge)))
        return self.Dense_1(h)


class LEConvDense(nn.Module):
    """Dense LEConv (ASAP's fitness scorer):
    out_i = W1 x_i + Σ_j A_ij (W2 x_i − W3 x_j)."""

    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        self.w1 = Dense(in_channels, channels)
        self.w2 = Dense(in_channels, channels)
        self.w3 = Dense(in_channels, channels)

    def forward(self, x, adj, node_mask):
        deg = adj.sum(-1, keepdim=True)
        out = self.w1(x) + deg * self.w2(x) \
            - torch.einsum("bij,bjc->bic", adj, self.w3(x))
        return out * node_mask[..., None]


class ASAPoolingDense(nn.Module):
    """Dense ASAPooling: LEConv fitness → top-⌈ratio·N⌉ cluster selection →
    attention-weighted cluster features → coarsened adjacency S^T A S.

    Static shapes, but pooling really pools: kept clusters sort to the
    front (scores descending by a stable sort, padding at _NEG last), so
    the per-sample keep mask is a contiguous prefix of length ≤ ⌈ratio·N⌉
    and the outputs are sliced to that bound.
    """

    def __init__(self, channels: int, ratio: float = 0.5):
        super().__init__()
        self.channels, self.ratio = channels, ratio
        self.att_q = Dense(channels, channels)
        self.att_k = Dense(channels, channels)
        self.fitness = LEConvDense(channels, 1)

    def forward(self, x, adj, node_mask
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        B, N, C = x.shape
        # ego-network attention: cluster i's representation attends over its
        # neighbors ∪ self
        eye = torch.eye(N, dtype=adj.dtype, device=adj.device)[None]
        adj_self = torch.clamp(adj + eye, 0.0, 1.0)
        logits = torch.einsum("bic,bjc->bij", self.att_q(x),
                              self.att_k(x)) / math.sqrt(self.channels)
        mask = (adj_self > 0) & node_mask[:, None, :]
        S = _masked_softmax(logits, mask)                      # [B, i, j]
        cluster_x = torch.einsum("bij,bjc->bic", S, x)

        # fitness scores via LEConv, masked top-k selection
        fitness = torch.tanh(self.fitness(cluster_x, adj, node_mask)[..., 0])
        scores = torch.where(node_mask, fitness, _NEG)
        keep_counts = torch.ceil(self.ratio * node_mask.sum(-1)).long()
        order = torch.argsort(-scores, dim=-1, stable=True)   # best first
        rank = torch.argsort(order, dim=-1, stable=True)
        keep = (rank < keep_counts[:, None]) & node_mask

        # gather kept clusters to the front; keep_counts ≤ n_keep always,
        # so slicing to n_keep drops only non-kept rows
        n_keep = int(math.ceil(self.ratio * N))
        head = order[:, :n_keep]
        x_perm = torch.gather(cluster_x * fitness[..., None], 1,
                              head[:, :, None].expand(B, n_keep, C))
        keep_perm = torch.gather(keep, 1, head)
        adj_rows = torch.gather(adj_self, 1, order[:, :, None].expand(B, N, N))
        adj_perm = torch.gather(adj_rows, 2, order[:, None, :].expand(B, N, N))
        # coarsened connectivity: clusters are adjacent if any member pair
        # is — only the kept block is needed, so slice the matmul operands
        adj2 = torch.clamp(adj_perm[:, :n_keep, :] @ adj_perm[:, :, :n_keep],
                           0.0, 1.0)
        adj2 = adj2 * keep_perm[:, :, None] * keep_perm[:, None, :]
        x_out = x_perm * keep_perm[..., None]
        return x_out, adj2, keep_perm


class _GraphBackbone(nn.Module):
    def __init__(self, in_channels: int, hidden_channels: int, heads1: int,
                 heads2: int):
        super().__init__()
        self.transformer1 = TransformerConvDense(
            in_channels, hidden_channels, heads1, dropout=0.1)
        self.pooling1 = ASAPoolingDense(hidden_channels * heads1, 0.5)
        self.transformer2 = TransformerConvDense(
            hidden_channels * heads1, hidden_channels, heads2, dropout=0.1)
        self.pooling2 = ASAPoolingDense(hidden_channels * heads2, 0.5)

    def forward(self, x, adj, node_mask):
        h = self.transformer1(x, adj, node_mask)
        h, adj, node_mask = self.pooling1(h, adj, node_mask)
        h = self.transformer2(h, adj, node_mask)
        h, adj, node_mask = self.pooling2(h, adj, node_mask)
        return global_mean_pool(h, node_mask.to(torch.float32))


class _GraphModel(nn.Module):
    """Backbone → concat(graph, noisy expvals, depth) → ``head``."""

    heads = (3, 2)

    def __init__(self, hidden_channels: int, exp_value_size: int,
                 num_node_features: int):
        super().__init__()
        h1, h2 = self.heads
        self.backbone = _GraphBackbone(num_node_features, hidden_channels,
                                       h1, h2)
        self.merge_size = hidden_channels * h2 + exp_value_size + 1

    def head(self, merge):
        raise NotImplementedError

    def forward(self, exp_value, observable, circuit_depth, x, adj,
                node_mask):
        B = x.shape[0]
        graph = self.backbone(x, adj, node_mask)
        merge = torch.cat([graph, exp_value.reshape(B, -1),
                           circuit_depth.reshape(B, 1)], dim=1)
        return self.head(merge)


class ExpValCircuitGraphModel(_GraphModel):
    """v1: heads 3/2, Linear+Dropout+Linear head (``gnn.py:70-122``)."""

    def __init__(self, hidden_channels: int, exp_value_size: int = 4,
                 dropout: float = 0.2, *, num_node_features: int):
        super().__init__(hidden_channels, exp_value_size, num_node_features)
        self.Dense_0 = Dense(self.merge_size, hidden_channels)
        self.Dense_1 = Dense(hidden_channels, exp_value_size)
        self.dropout = Dropout(dropout)

    def head(self, merge):
        return self.Dense_1(self.dropout(self.Dense_0(merge)))


class ExpValCircuitGraphModel2(_GraphModel):
    """v2: MLP2 head (``gnn.py:126-173``)."""

    def __init__(self, hidden_channels: int, exp_value_size: int = 4,
                 dropout: float = 0.5, *, num_node_features: int):
        super().__init__(hidden_channels, exp_value_size, num_node_features)
        self.MLP2_0 = MLP2(hidden_channels, exp_value_size, dropout,
                           input_size=self.merge_size)

    def head(self, merge):
        return self.MLP2_0(merge)


class ExpValCircuitGraphModel3(_GraphModel):
    """v3 — the paper's GNN: heads 5/3, MLP3 head with 5× hidden
    (``gnn.py:178-224``)."""

    heads = (5, 3)

    def __init__(self, hidden_channels: int, exp_value_size: int = 4,
                 dropout: float = 0.3, *, num_node_features: int):
        super().__init__(hidden_channels, exp_value_size, num_node_features)
        self.MLP3_0 = MLP3(hidden_channels * 5, exp_value_size, dropout,
                           input_size=self.merge_size)

    def head(self, merge):
        return self.MLP3_0(merge)


class ExpValCircuitGraphModel4(_GraphModel):
    """v4: like v3 but MLP3 hidden = hidden_channels (``gnn.py:229-276``)."""

    heads = (5, 3)

    def __init__(self, hidden_channels: int, exp_value_size: int = 4,
                 dropout: float = 0.3, *, num_node_features: int):
        super().__init__(hidden_channels, exp_value_size, num_node_features)
        self.MLP3_0 = MLP3(hidden_channels, exp_value_size, dropout,
                           input_size=self.merge_size)

    def head(self, merge):
        return self.MLP3_0(merge)
