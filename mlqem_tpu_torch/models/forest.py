"""Native random-forest regressor.

Counterpart of ``mlqem_tpu/models/forest.py``. The paper's best mitigation
model is sklearn's ``RandomForestRegressor(n_estimators=300)``
(``docs/tutorials/vqe_rf.py:147``, demo1's per-qubit
``RandomForest(100)``). CART trees are fit on the host with fully
vectorized exact split search (numpy; the JAX package's code, so the same
``random_state`` grows the same trees), then the ensemble is stacked into
flat [T, N] arrays on ``device``, and prediction walks all trees and
samples at once: one round of ``torch.gather`` per tree level.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np
import torch


@dataclasses.dataclass
class _TreeArrays:
    feature: np.ndarray    # int32[N]   (-1 at leaves)
    threshold: np.ndarray  # float32[N]
    left: np.ndarray       # int32[N]   (self at leaves)
    right: np.ndarray      # int32[N]
    value: np.ndarray      # float32[N, K]
    depth: int


def _fit_tree(X: np.ndarray, y: np.ndarray, rng: np.random.Generator,
              max_depth: Optional[int], min_samples_split: int,
              min_samples_leaf: int, max_features: Optional[int]
              ) -> _TreeArrays:
    n, F = X.shape
    K = y.shape[1]
    feature: List[int] = []
    threshold: List[float] = []
    left: List[int] = []
    right: List[int] = []
    value: List[np.ndarray] = []
    max_seen_depth = 0

    def new_node():
        feature.append(-1)
        threshold.append(0.0)
        left.append(-1)
        right.append(-1)
        value.append(np.zeros(K, np.float32))
        return len(feature) - 1

    def best_split(idx: np.ndarray):
        """Vectorized exact split search over (sub)features."""
        Xs = X[idx]
        ys = y[idx]
        m = idx.shape[0]
        if max_features is not None and max_features < F:
            feats = rng.choice(F, size=max_features, replace=False)
        else:
            # random order so exact-SSE ties resolve to a random feature
            # (sklearn shuffles features per node the same way)
            feats = rng.permutation(F)
        order = np.argsort(Xs[:, feats], axis=0, kind="stable")  # [m, f]
        xs_sorted = np.take_along_axis(Xs[:, feats], order, axis=0)
        # float64 criterion: float32 cumsums quantize the SSE enough to
        # flip split choices between near-tied candidates (measured: a
        # ~30% test-RMSE inflation on the demo1 mimic task)
        ys_sorted = ys[order].astype(np.float64)                 # [m, f, K]
        s1 = np.cumsum(ys_sorted, axis=0)                        # [m, f, K]
        s2 = np.cumsum(ys_sorted ** 2, axis=0)
        tot1 = s1[-1]                                            # [f, K]
        tot2 = s2[-1]
        counts = np.arange(1, m, dtype=np.float64)[:, None]      # left sizes
        l1, l2 = s1[:-1], s2[:-1]
        r1, r2 = tot1[None] - l1, tot2[None] - l2
        sse = (l2.sum(-1) - (l1 ** 2).sum(-1) / counts) + \
              (r2.sum(-1) - (r1 ** 2).sum(-1) / (m - counts))
        # invalid split positions: equal adjacent feature values, or a side
        # smaller than min_samples_leaf
        valid = xs_sorted[1:] > xs_sorted[:-1]
        if min_samples_leaf > 1:
            pos = np.arange(1, m)[:, None]
            valid &= (pos >= min_samples_leaf) & \
                     (m - pos >= min_samples_leaf)
        sse = np.where(valid, sse, np.inf)
        smin = sse.min()
        if not np.isfinite(smin):
            return None
        # uniform choice among exact ties: a deterministic argmin breaks
        # every tie toward the smallest (position, feature) — i.e. the
        # most unbalanced split on the earliest feature — which CORRELATES
        # the trees and measurably hurts the ensemble on data with
        # discrete/duplicated features
        ties = np.flatnonzero(sse <= smin + 1e-12 * max(abs(smin), 1.0))
        k = ties[rng.integers(0, ties.size)]
        row, col = np.unravel_index(k, sse.shape)
        f = int(feats[col])
        a = float(xs_sorted[row, col])
        b = float(xs_sorted[row + 1, col])
        thr = 0.5 * (a + b)
        # float32 midpoint of adjacent representable values can round up
        # to b, emptying the right branch (infinite recursion in grow);
        # splitting at a keeps both sides nonempty since valid ⇒ b > a
        if np.float32(thr) >= np.float32(b):
            thr = a
        return f, thr, sse[row, col]

    def grow(idx: np.ndarray, depth: int) -> int:
        nonlocal max_seen_depth
        max_seen_depth = max(max_seen_depth, depth)
        node = new_node()
        ys = y[idx]
        value[node] = ys.mean(axis=0).astype(np.float32)
        if (max_depth is not None and depth >= max_depth) \
                or idx.shape[0] < min_samples_split \
                or np.all(ys.var(axis=0) < 1e-12):
            left[node] = right[node] = node
            return node
        split = best_split(idx)
        if split is None:
            left[node] = right[node] = node
            return node
        f, thr, _ = split
        mask = X[idx, f] <= thr
        if mask.all() or not mask.any():   # degenerate split → leaf
            left[node] = right[node] = node
            return node
        li = grow(idx[mask], depth + 1)
        ri = grow(idx[~mask], depth + 1)
        feature[node] = f
        threshold[node] = thr
        left[node] = li
        right[node] = ri
        return node

    grow(np.arange(n), 0)
    return _TreeArrays(
        np.asarray(feature, np.int32), np.asarray(threshold, np.float32),
        np.asarray(left, np.int32), np.asarray(right, np.int32),
        np.stack(value).astype(np.float32), max_seen_depth)


def forest_predict(X: torch.Tensor, feature: torch.Tensor,
                   threshold: torch.Tensor, left: torch.Tensor,
                   right: torch.Tensor, value: torch.Tensor, depth: int
                   ) -> torch.Tensor:
    """Batched ensemble traversal.

    X[B, F] float32; tree arrays stacked [T, N] (int64 feature, left,
    right; float32 threshold) and value [T, N, K]. Per level: gather each
    sample's split feature/threshold at its current node and step — leaves
    self-loop so ragged depths are safe. Returns the tree mean [B, K].
    """
    T = feature.shape[0]
    B = X.shape[0]
    idx = torch.zeros((T, B), dtype=torch.int64, device=X.device)
    b_ar = torch.arange(B, device=X.device)[None, :]
    for _ in range(depth):
        f = torch.gather(feature, 1, idx)                    # [T, B]
        thr = torch.gather(threshold, 1, idx)
        go_left = (f >= 0) & (X[b_ar, f.clamp(min=0)] <= thr)
        idx = torch.where(go_left, torch.gather(left, 1, idx),
                          torch.gather(right, 1, idx))
    K = value.shape[2]
    leaf_vals = torch.gather(value, 1, idx[:, :, None].expand(T, B, K))
    return leaf_vals.mean(dim=0)                             # [B, K]


class RandomForestRegressor:
    """sklearn-shaped API: ``fit(X, y)`` / ``predict(X)``.

    Defaults mirror sklearn's regressor: bootstrap sampling, all features
    considered per split, trees grown to purity. ``fit`` runs on the host;
    the fitted ensemble lives on ``device``, where ``predict`` runs.
    """

    def __init__(self, n_estimators: int = 100,
                 max_depth: Optional[int] = None,
                 min_samples_split: int = 2,
                 min_samples_leaf: int = 1,
                 max_features: Optional[float] = None,
                 bootstrap: bool = True,
                 random_state: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.min_samples_split = min_samples_split
        self.min_samples_leaf = min_samples_leaf
        self.max_features = max_features
        self.bootstrap = bootstrap
        self.random_state = random_state
        self.device = torch.device(device)
        self._stacked = None
        self._depth = 0
        self._single_output = True

    def fit(self, X, y):
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float32)
        self._single_output = y.ndim == 1
        if self._single_output:
            y = y[:, None]
        n, F = X.shape
        mf = None
        if self.max_features is not None:
            mf = max(1, int(round(self.max_features * F))) \
                if isinstance(self.max_features, float) else int(
                    self.max_features)
        rng = np.random.default_rng(self.random_state)
        trees = []
        for _ in range(self.n_estimators):
            if self.bootstrap:
                idx = rng.integers(0, n, size=n)
                Xb, yb = X[idx], y[idx]
            else:
                Xb, yb = X, y
            trees.append(_fit_tree(Xb, yb, rng, self.max_depth,
                                   self.min_samples_split,
                                   self.min_samples_leaf, mf))
        max_nodes = max(t.feature.shape[0] for t in trees)
        T = len(trees)
        K = trees[0].value.shape[1]
        feature = np.full((T, max_nodes), -1, np.int32)
        threshold = np.zeros((T, max_nodes), np.float32)
        left = np.zeros((T, max_nodes), np.int32)
        right = np.zeros((T, max_nodes), np.int32)
        value = np.zeros((T, max_nodes, K), np.float32)
        for i, t in enumerate(trees):
            m = t.feature.shape[0]
            feature[i, :m] = t.feature
            threshold[i, :m] = t.threshold
            left[i, :m] = t.left
            right[i, :m] = t.right
            value[i, :m] = t.value
            # padding nodes self-loop at 0-valued leaves (never reached)
            left[i, m:] = np.arange(m, max_nodes)
            right[i, m:] = np.arange(m, max_nodes)
        self.set_stacked(feature, threshold, left, right, value,
                         max(t.depth for t in trees) + 1)
        return self

    def set_stacked(self, feature, threshold, left, right, value,
                    depth: int):
        """Place a stacked ensemble ([T, N] node arrays, value [T, N, K],
        its traversal depth) on ``device``."""
        def dev(a, dtype):
            return torch.as_tensor(np.array(a), dtype=dtype,
                                   device=self.device)

        self._stacked = (dev(feature, torch.int64),
                         dev(threshold, torch.float32),
                         dev(left, torch.int64), dev(right, torch.int64),
                         dev(value, torch.float32))
        self._depth = int(depth)
        return self

    def predict(self, X) -> np.ndarray:
        if self._stacked is None:
            raise RuntimeError("fit() before predict()")
        X = torch.as_tensor(np.asarray(X, np.float32), device=self.device)
        out = forest_predict(X, *self._stacked, self._depth).cpu().numpy()
        return out[:, 0] if self._single_output else out
