"""TUDataset-format loader for graph classification corpora.

Parses the standard TU benchmark layout the reference consumes through
DGL's TUDataset (reference data_util.py:47-57): `DS_A.txt` (1-indexed
global edge list), `DS_graph_indicator.txt` (node→graph membership),
`DS_graph_labels.txt`. Labels are remapped to a dense 0..C-1 range.
"""

from __future__ import annotations

import os

import numpy as np

from gcc_tpu_torch.graph.csr import CSRGraph

TU_NAMES = {
    "imdb-binary": "IMDB-BINARY",
    "imdb-multi": "IMDB-MULTI",
    "rdt-b": "REDDIT-BINARY",
    "rdt-5k": "REDDIT-MULTI-5K",
    "collab": "COLLAB",
}


def load_tu_dataset(
    name: str, data_root: str = "data"
) -> tuple[list[CSRGraph], np.ndarray]:
    ds = TU_NAMES.get(name, name)
    root = os.path.join(data_root, ds)
    prefix = os.path.join(root, ds)

    edges = np.loadtxt(f"{prefix}_A.txt", delimiter=",", dtype=np.int64)
    indicator = np.loadtxt(f"{prefix}_graph_indicator.txt", dtype=np.int64)
    labels_raw = np.loadtxt(f"{prefix}_graph_labels.txt", dtype=np.int64)

    # 1-indexed -> 0-indexed.
    edges = edges - 1
    indicator = indicator - 1
    num_graphs = int(indicator.max()) + 1

    # Node id offsets per graph (nodes are contiguous per graph).
    counts = np.bincount(indicator, minlength=num_graphs)
    offsets = np.zeros(num_graphs + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])

    src_g = indicator[edges[:, 0]]
    order = np.argsort(src_g, kind="stable")
    edges_sorted = edges[order]
    graph_of_edge = src_g[order]
    edge_counts = np.bincount(graph_of_edge, minlength=num_graphs)
    edge_offsets = np.zeros(num_graphs + 1, dtype=np.int64)
    np.cumsum(edge_counts, out=edge_offsets[1:])

    graphs = []
    for gi in range(num_graphs):
        e = edges_sorted[edge_offsets[gi]: edge_offsets[gi + 1]]
        local = e - offsets[gi]
        graphs.append(
            CSRGraph.from_edges(
                local[:, 0], local[:, 1], num_nodes=int(counts[gi])
            )
        )

    # Dense label remap (sorted unique -> 0..C-1).
    uniq = np.unique(labels_raw)
    remap = {int(v): i for i, v in enumerate(uniq)}
    labels = np.array([remap[int(v)] for v in labels_raw], dtype=np.int64)
    return graphs, labels


def save_tu_dataset(root: str, name: str, graphs: list[CSRGraph],
                    labels: np.ndarray) -> None:
    """Write the TU layout (used by tests/benchmarks to fabricate data)."""
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    prefix = os.path.join(d, name)
    rows = []
    indicator = []
    offset = 0
    for gi, g in enumerate(graphs):
        for u in range(g.num_nodes):
            for v in g.neighbors(u):
                rows.append((u + offset + 1, int(v) + offset + 1))
        indicator.extend([gi + 1] * g.num_nodes)
        offset += g.num_nodes
    np.savetxt(f"{prefix}_A.txt", np.array(rows, np.int64), fmt="%d",
               delimiter=", ")
    np.savetxt(f"{prefix}_graph_indicator.txt",
               np.array(indicator, np.int64), fmt="%d")
    np.savetxt(f"{prefix}_graph_labels.txt", np.asarray(labels, np.int64),
               fmt="%d")
