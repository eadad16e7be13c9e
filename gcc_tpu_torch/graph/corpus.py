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


REFERENCE_SCALE_SHAPES = (
    # (name, num_nodes, avg_degree) mirroring the reference pretraining
    # corpus's published graph scales (x2dgl.py:88-97: two DBLP
    # co-author graphs, IMDB, Academia, LiveJournal, Facebook; the
    # LiveJournal LSCC is ~4.8M nodes / ~43M undirected edges).
    ("dblp-netrep", 540_000, 30),
    ("dblp-snap", 317_000, 7),
    ("imdb-netrep", 896_000, 9),
    ("academia", 200_000, 14),
    ("livejournal", 4_847_000, 17),
    ("facebook", 3_000_000, 16),
)


def synthetic_corpus_reference_scale(path: str, seed: int = 0,
                                     sort_rows: bool = True) -> CorpusStore:
    """Synthetic corpus at the reference corpus's shape
    (``gcc_tpu/graph/corpus.py:136``): heavy-tailed graphs (all six
    reference graphs are social or collaboration networks) at its node
    and edge scales, so that walks and extraction can be measured where
    the CSR outgrows the host's last-level cache. ~150M edges, ~700 MB on
    disk; vectorized numpy, one graph in memory at a time.

    sort_rows (default True) sorts each CSR row's neighbours ascending
    and records ``rows_sorted`` in the manifest, which enables the native
    sampler's binary-search extraction of hub rows. Walks differ from an
    unsorted build's (row order feeds the neighbour picks) but are
    distributionally identical. The files are the reference's byte for
    byte."""
    rng = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)
    entries = []
    for i, (name, n, deg) in enumerate(REFERENCE_SCALE_SHAPES):
        m = n * deg // 2
        src = (n * rng.random(m) ** 2.0).astype(np.int64)
        dst = rng.integers(0, n, m)
        keep = src != dst
        g = CSRGraph.from_edges(src[keep], dst[keep], num_nodes=n,
                                symmetrize=True, sort_rows=sort_rows)
        np.save(os.path.join(path, f"g{i}.indptr.npy"),
                np.asarray(g.indptr, np.int64))
        np.save(os.path.join(path, f"g{i}.indices.npy"),
                np.asarray(g.indices, np.int32))
        entries.append({"name": name, "num_nodes": int(g.num_nodes),
                        "num_edges": int(g.num_edges)})
        del g, src, dst, keep
    manifest = {"version": 1, "graphs": entries}
    if sort_rows:
        manifest["rows_sorted"] = True
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return CorpusStore(path, manifest)


def synthetic_corpus_diverse(
    path: str,
    nodes_per_graph: int = 100_000,
    avg_degree: int = 12,
    seed: int = 0,
) -> CorpusStore:
    """Family-diverse synthetic pretraining corpus
    (``gcc_tpu/graph/corpus.py:183``; its files byte for byte).

    The reference's 6-graph corpus spans structurally different real
    graphs, while :func:`synthetic_corpus` draws all six from one
    heavy-tail generator. Six graphs, one per ensemble, all vectorized
    numpy:

      0 heavy-tail preferential-attachment flavor (= synthetic_corpus)
      1 Erdos-Renyi (Poisson degrees, no structure)
      2 ring lattice + 10% rewire (Watts-Strogatz flavor: high
        clustering, near-constant degree)
      3 random near-regular (stub pairing)
      4 planted 64-community graph (5:1 in/out edge ratio)
      5 heavy-tail + triadic closure (Holme-Kim flavor: hubs AND
        triangles)
    """
    rng = np.random.default_rng(seed)
    n = nodes_per_graph
    m = n * avg_degree // 2
    graphs = []

    def ht_edges(rng, n, m):
        src = (n * rng.random(m) ** 2.0).astype(np.int64)
        dst = rng.integers(0, n, m)
        return src, dst

    # 0 heavy tail
    graphs.append(ht_edges(rng, n, m))
    # 1 Erdos-Renyi
    graphs.append((rng.integers(0, n, m), rng.integers(0, n, m)))
    # 2 ring lattice + rewire
    k = avg_degree // 2
    src = np.repeat(np.arange(n, dtype=np.int64), k)
    dst = (src + np.tile(np.arange(1, k + 1, dtype=np.int64), n)) % n
    rewire = rng.random(src.shape[0]) < 0.10
    dst = np.where(rewire, rng.integers(0, n, src.shape[0]), dst)
    graphs.append((src, dst))
    # 3 random near-regular (stub pairing)
    stubs = rng.permutation(np.repeat(np.arange(n, dtype=np.int64),
                                      avg_degree))
    graphs.append((stubs[0::2], stubs[1::2]))
    # 4 planted communities
    comm = rng.integers(0, 64, n)
    draws = 5 * m  # rejection keeps ~21.6% (1/64 + 63/64·0.2) — 5x
    #                oversampling leaves ≥ m survivors to trim to
    s = rng.integers(0, n, draws)
    d = rng.integers(0, n, draws)
    same = comm[s] == comm[d]
    # keep all within-community draws + a 1/5 slice of the rest, then
    # trim to m edges: ~5:1 in/out ratio at ER-like degrees.
    keep = same | (rng.random(draws) < 0.2)
    s, d = s[keep][:m], d[keep][:m]
    graphs.append((s, d))
    # 5 heavy tail + triadic closure: connect random co-neighbors of the
    # same hub by sampling two endpoints that chose the same dst bucket.
    src, dst = ht_edges(rng, n, m * 3 // 4)
    order = np.argsort(src, kind="stable")
    ss, ds = src[order], dst[order]
    adjacent = ss[:-1] == ss[1:]
    tri_s, tri_d = ds[:-1][adjacent], ds[1:][adjacent]
    graphs.append((np.concatenate([src, tri_s[: m // 4]]),
                   np.concatenate([dst, tri_d[: m // 4]])))

    out = []
    for src, dst in graphs:
        keep = src != dst
        out.append(CSRGraph.from_edges(src[keep], dst[keep], num_nodes=n,
                                       symmetrize=True))
    return CorpusStore.create(path, out)
