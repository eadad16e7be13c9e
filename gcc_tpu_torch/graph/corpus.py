"""Pretraining corpus store: mmap-backed CSR shards + JSON manifest.

Each graph is two flat ``.npy`` files (indptr, indices) memory-mapped on
open, so sampler workers each map only their partition with zero copy
and the OS page cache shares hot pages across them. The on-disk format
is the one ``gcc_tpu.graph.corpus`` writes, so both packages read the
same corpora.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np

from gcc_tpu_torch.graph.csr import CSRGraph


class CorpusStore:
    """A directory of CSR graphs with a manifest."""

    def __init__(self, path: str, manifest: dict):
        self.path = path
        self.manifest = manifest

    @property
    def num_graphs(self) -> int:
        return len(self.manifest["graphs"])

    @property
    def graph_sizes(self) -> list[int]:
        """Node counts, the load-balance key (reference 'graph_sizes')."""
        return [g["num_nodes"] for g in self.manifest["graphs"]]

    @staticmethod
    def create(path: str, graphs: Sequence[CSRGraph],
               names: Sequence[str] | None = None) -> "CorpusStore":
        os.makedirs(path, exist_ok=True)
        entries = []
        for i, g in enumerate(graphs):
            np.save(os.path.join(path, f"g{i}.indptr.npy"),
                    np.asarray(g.indptr, np.int64))
            np.save(os.path.join(path, f"g{i}.indices.npy"),
                    np.asarray(g.indices, np.int32))
            entries.append({
                "name": names[i] if names else f"g{i}",
                "num_nodes": int(g.num_nodes),
                "num_edges": int(g.num_edges),
            })
        manifest = {"version": 1, "graphs": entries}
        if graphs and all(g.rows_sorted for g in graphs):
            manifest["rows_sorted"] = True
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        return CorpusStore(path, manifest)

    @staticmethod
    def open(path: str) -> "CorpusStore":
        with open(os.path.join(path, "manifest.json")) as f:
            return CorpusStore(path, json.load(f))

    def load(self, i: int, mmap: bool = True) -> CSRGraph:
        mode = "r" if mmap else None
        indptr = np.load(os.path.join(self.path, f"g{i}.indptr.npy"),
                         mmap_mode=mode)
        indices = np.load(os.path.join(self.path, f"g{i}.indices.npy"),
                          mmap_mode=mode)
        return CSRGraph(indptr=indptr, indices=indices,
                        rows_sorted=bool(self.manifest.get("rows_sorted",
                                                           False)))


def partition_graphs(sizes: Sequence[int], num_workers: int,
                     num_copies: int = 1) -> list[list[int]]:
    """Greedy size-balanced assignment of graphs to workers (reference
    graph_dataset.py:63-76): sort descending, give each graph to the
    least-loaded worker; the whole assignment is replicated num_copies
    times."""
    assert num_workers % num_copies == 0
    slots = num_workers // num_copies
    jobs: list[list[int]] = [[] for _ in range(slots)]
    load = [0] * slots
    order = sorted(enumerate(sizes), key=lambda kv: kv[1], reverse=True)
    for idx, size in order:
        w = load.index(min(load))
        load[w] += size
        jobs[w].append(idx)
    return jobs * num_copies


def synthetic_corpus(
    path: str,
    num_graphs: int = 6,
    nodes_per_graph: int = 20000,
    avg_degree: int = 10,
    seed: int = 0,
) -> CorpusStore:
    """Generate a synthetic pretraining corpus (power-law-ish multi-graph
    collection standing in for the reference's 6-graph kdd17 corpus —
    benchmarks and smoke runs have no network, so they use synthetic
    graphs of the same scale/shape)."""
    rng = np.random.default_rng(seed)
    graphs = []
    for gi in range(num_graphs):
        n = int(nodes_per_graph * (0.5 + rng.random()))
        m = n * avg_degree // 2
        # Preferential-attachment-flavored edges: bias endpoints toward
        # low ids for a heavy-tailed degree distribution.
        src = (n * rng.random(m) ** 2.0).astype(np.int64)
        dst = rng.integers(0, n, m)
        keep = src != dst
        graphs.append(
            CSRGraph.from_edges(src[keep], dst[keep], num_nodes=n,
                                symmetrize=True)
        )
    return CorpusStore.create(path, graphs)
