"""Dataset persistence + loading.

The port's copy of ``mlqem_tpu/data/loaders.py`` (host numpy). Parity with
``CircuitGraphExpValMitigationDataset``
(``blackwater/data/loaders/exp_val.py:13-82``): loads ``.json``/``.pk``
entry lists (the reference's on-disk format works unchanged), strips
``circuit``/``metadata`` keys, and materializes padded-array batches for the
models. Adds an ``.npz`` array format for large datasets.
"""
from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from .generators import ExpValueEntry


def save_entries_json(entries: Sequence[ExpValueEntry], path: str):
    with open(path, "w") as f:
        json.dump([e.to_dict() for e in entries], f)


def load_entries(path: str) -> List[ExpValueEntry]:
    """Load a reference-format entry list (.json or pickle .pk/.pkl)."""
    if path.endswith((".pk", ".pkl", ".pickle")):
        with open(path, "rb") as f:
            raw = pickle.load(f)
    else:
        with open(path) as f:
            raw = json.load(f)
    entries = []
    for d in raw:
        d = dict(d)
        d.pop("circuit", None)      # reference loader strips these keys
        d.pop("metadata", None)
        entries.append(ExpValueEntry.from_json(d))
    return entries


class ExpValDataset:
    """In-memory dataset of graph entries with padded-array batching.

    The PyG-free equivalent of ``CircuitGraphExpValMitigationDataset``:
    every entry becomes fixed-shape arrays (node features, edge index,
    masks), optionally with self-loops added (the reference's default
    ``AddSelfLoops`` transform).
    """

    def __init__(self, paths_or_entries, add_self_loops: bool = True,
                 max_nodes: Optional[int] = None,
                 max_edges: Optional[int] = None):
        if isinstance(paths_or_entries, (str, os.PathLike)):
            paths_or_entries = [paths_or_entries]
        entries: List[ExpValueEntry] = []
        for item in paths_or_entries:
            if isinstance(item, ExpValueEntry):
                entries.append(item)
            else:
                entries.extend(load_entries(str(item)))
        if not entries:
            raise ValueError("no entries loaded")
        self.entries = entries
        self.add_self_loops = add_self_loops

        sizes_n = [len(e.circuit_graph["nodes"]["DAGOpNode"])
                   for e in entries]
        key = "DAGOpNode_wire_DAGOpNode"
        sizes_e = [len(e.circuit_graph["edges"].get(
            key, {"edge_index": [[], []]})["edge_index"][0])
            for e in entries]
        self.max_nodes = max_nodes or max(max(sizes_n), 1)
        base_edges = max(max(sizes_e), 1)
        # self-loops add one edge per node
        self.max_edges = max_edges or (
            base_edges + (self.max_nodes if add_self_loops else 0))
        self._arrays = self._materialize()

    def _materialize(self) -> Dict[str, np.ndarray]:
        batches = [e.to_arrays(self.max_nodes, self.max_edges - (
            self.max_nodes if self.add_self_loops else 0))
            for e in self.entries]
        out: Dict[str, List[np.ndarray]] = {}
        for b in batches:
            for k, v in b.items():
                out.setdefault(k, []).append(np.asarray(v))
        arrays = {k: np.stack(v) for k, v in out.items()}
        if self.add_self_loops:
            B = len(self.entries)
            N = self.max_nodes
            loops = np.broadcast_to(np.arange(N, dtype=np.int32),
                                    (B, N))[:, None, :]
            loop_edges = np.concatenate([loops, loops], axis=1)  # [B,2,N]
            arrays["edge_index"] = np.concatenate(
                [arrays["edge_index"], loop_edges], axis=2)
            arrays["edge_mask"] = np.concatenate(
                [arrays["edge_mask"], arrays["node_mask"]], axis=1)
        return arrays

    def __len__(self):
        return len(self.entries)

    @property
    def arrays(self) -> Dict[str, np.ndarray]:
        """Full padded batch: x[B,N,F], edge_index[B,2,E], masks, y[B],
        observable[B,T,W], circuit_depth[B], noisy[B,K]."""
        return self._arrays

    def batches(self, batch_size: int, shuffle: bool = True,
                seed: int = 0):
        """Yield dict minibatches."""
        B = len(self.entries)
        idx = np.arange(B)
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        for s in range(0, B, batch_size):
            sel = idx[s:s + batch_size]
            yield {k: v[sel] for k, v in self._arrays.items()}


def save_arrays_npz(arrays: Dict[str, np.ndarray], path: str):
    """Array-format persistence (bulk storage)."""
    np.savez_compressed(path, **arrays)


def load_arrays_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}
