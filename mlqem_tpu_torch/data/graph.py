"""Circuit → DAG-graph encoding.

The port's copy of ``mlqem_tpu/data/graph.py`` (host numpy). Output-parity
rebuild of ``circuit_to_graph_data_json``
(``blackwater/data/utils.py:198-389``): heterogeneous JSON graph whose
DAGOpNode feature vector is [3 gate params | gate-type one-hot over
gates_set+(barrier,measure) | optional per-qubit t1/t2/readout (3 slots
each) | optional gate_error/gate_length]. For FakeLima this is the 22-dim
node feature the paper GNN trains on (``gnn.py:313-317``).

Plus the batch form: padded node/edge arrays + dense adjacency so the GNN
runs as masked dense matmuls instead of PyG sparse ops.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..circuits.circuit import Circuit


def circuit_to_graph_data_json(circuit: Circuit, properties: dict,
                               use_gate_features: bool = False,
                               use_qubit_features: bool = False) -> dict:
    """Reference-schema graph dict (see module docstring).

    Structural 'delay'/'reset' ops are skipped (the reference's feature map
    covers gates_set + barrier + measure only).
    """
    gate_types = list(properties["gates_set"]) + ["barrier", "measure"]
    type_index = {g: i for i, g in enumerate(gate_types)}
    qprops = properties["qubits_props"]
    gprops = properties.get("gate_props", {})

    op_features: List[List[float]] = []
    op_qubits: List[Tuple[int, ...]] = []
    for op in circuit.ops:
        if op.name not in type_index:
            continue
        params3 = [0.0, 0.0, 0.0]
        for i, p in enumerate(op.params[:3]):
            params3[i] = float(p)
        onehot = [0.0] * len(gate_types)
        onehot[type_index[op.name]] = 1.0
        feature = params3 + onehot
        if use_qubit_features:
            # 3 slots (max operable gate size); barriers get zeros
            qp = [{} for _ in range(3)]
            if op.name != "barrier":
                for i, q in enumerate(op.qubits[:3]):
                    qp[i] = qprops[q]
            feature += [v.get("t1", 0.0) for v in qp]
            feature += [v.get("t2", 0.0) for v in qp]
            feature += [v.get("readout_error", 0.0) for v in qp]
        if use_gate_features:
            key = f"{op.name}_{'_'.join(str(q) for q in op.qubits)}"
            gp = gprops.get(key, {})
            feature += [gp.get("gate_error", 0.0), gp.get("gate_length", 0.0)]
        op_features.append(feature)
        op_qubits.append(op.qubits)

    # wire edges: last-writer per qubit
    n = circuit.num_qubits
    last: List[Optional[int]] = [None] * n
    edges_opop: List[Tuple[int, int, int]] = []   # (src, dst, wire)
    edges_inop: List[Tuple[int, int, int]] = []   # (in-node idx, dst, wire)
    edges_opout: List[Tuple[int, int, int]] = []
    for idx, qubits in enumerate(op_qubits):
        for q in qubits:
            if last[q] is None:
                edges_inop.append((q, idx, q))
            else:
                edges_opop.append((last[q], idx, q))
            last[q] = idx
    for q in range(n):
        if last[q] is not None:
            edges_opout.append((last[q], q, q))

    def edge_group(triples):
        if not triples:
            return {"edge_index": [[], []], "edge_attr": []}
        srcs = [t[0] for t in triples]
        dsts = [t[1] for t in triples]
        attrs = [[qprops[t[2]]["t1"], qprops[t[2]]["t2"],
                  qprops[t[2]]["readout_error"]] for t in triples]
        return {"edge_index": [srcs, dsts], "edge_attr": attrs}

    data: Dict[str, Dict] = {"nodes": {}, "edges": {}}
    data["nodes"]["DAGOpNode"] = op_features
    data["nodes"]["DAGInNode"] = [[0, 0] for _ in range(n)]
    data["nodes"]["DAGOutNode"] = [[0, 0] for _ in range(n)]
    data["edges"]["DAGInNode_wire_DAGOpNode"] = edge_group(edges_inop)
    data["edges"]["DAGOpNode_wire_DAGOpNode"] = edge_group(edges_opop)
    data["edges"]["DAGOpNode_wire_DAGOutNode"] = edge_group(edges_opout)
    return data


def circuit_to_homogeneous_graph(circuit: Circuit,
                                 gate_set=None) -> dict:
    """Homogeneous graph encoding (``circuit_to_pyg_data`` parity,
    ``data/utils.py:52-123``).

    Node feature = [gate one-hot over the 26-name reference vocabulary +
    (barrier, measure, delay)] ++ [affected-qubit indicator (num_qubits)]
    ++ [3 params]. Wire edges between op nodes; edge_attr all-zero 1-dim.
    For a 2q H+CX+measure_all circuit this gives x (5, 34), edge_index
    (2, 5) — the reference test's golden shapes.
    """
    from ..circuits.gates import REFERENCE_VOCAB

    gate_set = list(gate_set or REFERENCE_VOCAB) + ["barrier", "measure",
                                                    "delay"]
    # map our canonical names onto the reference vocabulary
    aliases = {"p": "u1", "cp": "cu1"}
    n = circuit.num_qubits
    feats: List[List[float]] = []
    qargs: List[Tuple[int, ...]] = []
    for op in circuit.ops:
        name = aliases.get(op.name, op.name)
        if name not in gate_set:
            continue
        onehot = [0.0] * len(gate_set)
        onehot[gate_set.index(name)] = 1.0
        affected = [0.0] * n
        for q in op.qubits:
            affected[q] = 1.0
        params = [0.0, 0.0, 0.0]
        for i, p in enumerate(op.params[:3]):
            params[i] = float(p)
        feats.append(onehot + affected + params)
        qargs.append(op.qubits)
    last: List[Optional[int]] = [None] * n
    src, dst = [], []
    for idx, qubits in enumerate(qargs):
        for q in qubits:
            if last[q] is not None:
                src.append(last[q])
                dst.append(idx)
            last[q] = idx
    return {
        "x": np.asarray(feats, dtype=np.float32),
        "edge_index": np.asarray([src, dst], dtype=np.int64),
        "edge_attr": np.zeros((1, len(src)), dtype=np.float32),
        "circuit_depth": circuit.depth(),
    }


def num_node_features(properties: dict, use_gate_features: bool = True,
                      use_qubit_features: bool = True) -> int:
    base = 3 + len(properties["gates_set"]) + 2
    if use_qubit_features:
        base += 9
    if use_gate_features:
        base += 2
    return base


# ---------------------------------------------------------------------------
# Padded-array batch form for the GNN
# ---------------------------------------------------------------------------
def graph_to_arrays(graph: dict, max_nodes: int, max_edges: int,
                    feat_width: Optional[int] = None):
    """One graph dict → (x[Nmax,F], edge_index[2,Emax], node_mask, edge_mask).

    Only DAGOpNode nodes and op→op wire edges are used — exactly the slice
    ``ExpValueEntry.to_pyg_data`` feeds the GNN
    (``data/generators/exp_val.py:63-89``). An empty circuit (0 ops, e.g. a
    0-step Trotter sample) pads to an all-masked graph; its feature width
    must then come from ``feat_width``.
    """
    x = np.asarray(graph["nodes"]["DAGOpNode"], dtype=np.float32)
    if x.size == 0:
        if feat_width is None:
            raise ValueError("empty graph needs an explicit feat_width")
        x = x.reshape(0, feat_width)
    n_nodes, feat = x.shape
    eg = graph["edges"].get("DAGOpNode_wire_DAGOpNode",
                            {"edge_index": [[], []], "edge_attr": []})
    ei = np.asarray(eg["edge_index"], dtype=np.int32).reshape(2, -1)
    n_edges = ei.shape[1]
    if n_nodes > max_nodes or n_edges > max_edges:
        raise ValueError(f"graph too large: {n_nodes} nodes/{n_edges} edges "
                         f"for padding ({max_nodes}/{max_edges})")
    xp = np.zeros((max_nodes, feat), dtype=np.float32)
    xp[:n_nodes] = x
    eip = np.zeros((2, max_edges), dtype=np.int32)
    eip[:, :n_edges] = ei
    node_mask = np.zeros(max_nodes, dtype=bool)
    node_mask[:n_nodes] = True
    edge_mask = np.zeros(max_edges, dtype=bool)
    edge_mask[:n_edges] = True
    return xp, eip, node_mask, edge_mask


def stack_graphs(graphs: Sequence[dict], max_nodes: Optional[int] = None,
                 max_edges: Optional[int] = None):
    """Batch of graph dicts → padded arrays dict for the GNN."""
    sizes_n = [len(g["nodes"]["DAGOpNode"]) for g in graphs]
    sizes_e = [len(g["edges"].get("DAGOpNode_wire_DAGOpNode",
                                  {"edge_index": [[], []]})
                   ["edge_index"][0]) for g in graphs]
    max_nodes = max_nodes or max(max(sizes_n), 1)
    max_edges = max_edges or max(max(sizes_e), 1)
    feat_width = next(
        (len(g["nodes"]["DAGOpNode"][0]) for g, n in zip(graphs, sizes_n)
         if n > 0), None)
    xs, eis, nms, ems = [], [], [], []
    for g in graphs:
        x, ei, nm, em = graph_to_arrays(g, max_nodes, max_edges, feat_width)
        xs.append(x)
        eis.append(ei)
        nms.append(nm)
        ems.append(em)
    return {
        "x": np.stack(xs),                 # [B, N, F]
        "edge_index": np.stack(eis),       # [B, 2, E]
        "node_mask": np.stack(nms),        # [B, N]
        "edge_mask": np.stack(ems),        # [B, E]
    }
