"""Corpus ingest tool (reference gcc/utils/x2dgl.py:28-131 equivalent).

Edge-list files → dedup, self-loop removal, symmetrize, keep largest
connected component, sort graphs by size descending, write a
:class:`CorpusStore` (the reference writes DGL GraphBin with a
graph_sizes label)."""

from __future__ import annotations

import numpy as np

from gcc_tpu_torch.graph.corpus import CorpusStore
from gcc_tpu_torch.graph.csr import CSRGraph, largest_connected_component


def edgelist_to_graph(path: str) -> CSRGraph:
    edges = np.loadtxt(path, dtype=np.int64, ndmin=2)
    src, dst = edges[:, 0], edges[:, 1]
    # Reindex raw ids to dense.
    uniq, inv = np.unique(np.concatenate([src, dst]), return_inverse=True)
    src, dst = inv[: len(src)], inv[len(src):]
    # Remove self loops; dedup undirected pairs.
    keep = src != dst
    src, dst = src[keep], dst[keep]
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    pairs = np.unique(np.stack([lo, hi], axis=1), axis=0)
    g = CSRGraph.from_edges(pairs[:, 0], pairs[:, 1], num_nodes=len(uniq),
                            symmetrize=True)
    cc = largest_connected_component(g)
    sub_src, sub_dst = g.induced_subgraph(cc)
    return CSRGraph.from_edges(sub_src, sub_dst, num_nodes=len(cc))


def ingest_edgelists(paths: list[str], out: str) -> CorpusStore:
    graphs = [edgelist_to_graph(p) for p in paths]
    order = np.argsort([-g.num_nodes for g in graphs])
    graphs = [graphs[i] for i in order]
    names = [paths[i] for i in order]
    return CorpusStore.create(out, graphs, names=names)
