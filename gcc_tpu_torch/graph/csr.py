"""Immutable CSR graph container (host side).

This is the framework's only graph object. It is a plain numpy CSR
adjacency — no feature dict, no mutation, no framework tensors — because
all featurization happens on-device from padded edge lists (see
``gcc_tpu_torch/features``) and all sampling happens in the native sampler
(``gcc_tpu_torch/sampling``) which consumes these arrays zero-copy.

Graphs are stored in *out*-adjacency CSR. The reference pipeline
(THUDM/GCC) operates on symmetrized graphs everywhere — edge lists are
inserted in both directions (reference ``gcc/datasets/data_util.py:61-108``,
``gcc/datasets/graph_dataset.py:301-309``) — so in/out degrees coincide;
we keep the directed representation for generality. Multi-edges are kept
(the similarity-search ``.graph`` format repeats each edge ``t`` times,
reference ``data_util.py:128-139``) since GIN sum-aggregation is
multiplicity-sensitive.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Compressed-sparse-row adjacency.

    Attributes:
      indptr: (num_nodes + 1,) int64 — row offsets into ``indices``.
      indices: (num_edges,) int32 — destination node of each out-edge.
      rows_sorted: True iff every row's neighbor ids are ascending. Set by
        ``from_edges(sort_rows=True)`` and by the corpus manifest; enables
        the native sampler's hub-row binary-search extraction (the win is
        at miss-bound corpus scales — docs/PERF.md round-5 refscale).
    """

    indptr: np.ndarray
    indices: np.ndarray
    rows_sorted: bool = False

    def __post_init__(self):
        assert self.indptr.ndim == 1 and self.indices.ndim == 1
        assert self.indptr[0] == 0 and self.indptr[-1] == len(self.indices)

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        return len(self.indices)

    def out_degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    # Symmetrized graphs: in == out. Kept as an explicit method so callers
    # that need true in-degree on a directed graph get the right thing.
    def in_degrees(self) -> np.ndarray:
        return np.bincount(self.indices, minlength=self.num_nodes).astype(np.int64)

    def neighbors(self, u: int) -> np.ndarray:
        return self.indices[self.indptr[u] : self.indptr[u + 1]]

    @staticmethod
    def from_edges(
        src: np.ndarray,
        dst: np.ndarray,
        num_nodes: int | None = None,
        symmetrize: bool = False,
        sort_rows: bool = False,
    ) -> "CSRGraph":
        """Build a CSR graph from an edge list.

        Args:
          src, dst: int arrays of equal length. Multi-edges are preserved.
          num_nodes: total node count (default: max id + 1).
          symmetrize: if True, also insert every reverse edge (the
            reference's "to undirected" convention).
          sort_rows: if True, sort neighbors ascending within each row and
            set ``rows_sorted`` (enables hub extraction). Off by default:
            row order feeds the walk RNG's neighbor picks, so sorting
            changes sampled trajectories — existing fixtures/corpora keep
            their recorded order; opt in for new (miss-bound) corpora.
        """
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        assert src.shape == dst.shape
        if symmetrize:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        if num_nodes is None:
            num_nodes = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
        if sort_rows:
            order = np.lexsort((dst, src))
        else:
            order = np.argsort(src, kind="stable")
        src_sorted = src[order]
        dst_sorted = dst[order]
        counts = np.bincount(src_sorted, minlength=num_nodes)
        indptr = np.zeros(num_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return CSRGraph(indptr=indptr, indices=dst_sorted.astype(np.int32),
                        rows_sorted=sort_rows)

    def induced_subgraph(self, nodes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Induced subgraph over ``nodes``, relabeled to 0..len(nodes)-1.

        Node order is preserved: ``nodes[i]`` becomes node ``i`` (the
        reference puts the walk seed at position 0, reference
        ``data_util.py:221-226``). Multi-edges among the selected nodes
        are all kept. Returns (sub_src, sub_dst) int32 arrays.

        This is the numpy oracle; the native sampler has a fused C++
        implementation of the same contract.
        """
        nodes = np.asarray(nodes, dtype=np.int64)
        relabel = -np.ones(self.num_nodes, dtype=np.int64)
        relabel[nodes] = np.arange(len(nodes))
        # Gather all out-edges of selected nodes, keep those landing in set.
        deg = np.diff(self.indptr)[nodes]
        sub_src_g = np.repeat(nodes, deg)
        starts = self.indptr[nodes]
        # Build flat index ranges per node.
        if len(nodes) == 0 or deg.sum() == 0:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32))
        idx = np.concatenate([np.arange(s, s + d) for s, d in zip(starts, deg)])
        sub_dst_g = self.indices[idx]
        keep = relabel[sub_dst_g] >= 0
        return (
            relabel[sub_src_g[keep]].astype(np.int32),
            relabel[sub_dst_g[keep]].astype(np.int32),
        )


def largest_connected_component(g: CSRGraph) -> np.ndarray:
    """Node ids of the largest (weakly) connected component.

    Used by the corpus ingest tool (reference ``gcc/utils/x2dgl.py:100-117``
    keeps only the largest CC of each pretraining graph).
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    n = g.num_nodes
    mat = sp.csr_matrix(
        (np.ones(g.num_edges, dtype=np.int8), g.indices, g.indptr), shape=(n, n)
    )
    ncomp, labels = connected_components(mat, directed=True, connection="weak")
    if ncomp <= 1:
        return np.arange(n)
    sizes = np.bincount(labels)
    return np.where(labels == sizes.argmax())[0]
