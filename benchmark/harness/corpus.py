"""The pre-training corpus and the generation dataset, made on the host.

A frozen copy of the port's synthetic corpus generator
(``gcc_tpu_torch/graph/corpus.py synthetic_corpus``): power-law-flavoured
multi-graphs, each edge inserted in both directions, stored as the
program's corpus directory (``manifest.json`` with ``g<i>.indptr.npy`` and
``g<i>.indices.npy``). The shape comes from the configuration file; the
graphs are written once per shape and generator under ``build/benchmark``
inside the checkout, keyed by a digest of both, and read from there by
every later run.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
CACHE_DIR = os.path.join(ROOT, "build", "benchmark")


def _graph_edges(rng: np.random.Generator, n: int, avg_degree: int):
    """One graph's directed edge list: n·avg_degree/2 draws, sources biased
    toward low ids (u², a heavy-tailed degree), self-loops dropped."""
    m = n * avg_degree // 2
    src = (n * rng.random(m) ** 2.0).astype(np.int64)
    dst = rng.integers(0, n, m)
    keep = src != dst
    return src[keep], dst[keep]


def csr_symmetric(src: np.ndarray, dst: np.ndarray, n: int):
    """(indptr int64, indices int32) of the graph with every edge in both
    directions, rows in stable source order, multi-edges kept."""
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    order = np.argsort(s, kind="stable")
    counts = np.bincount(s[order], minlength=n)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, d[order].astype(np.int32)


def corpus_graphs(num_graphs: int, nodes_per_graph: int, avg_degree: int,
                  seed: int):
    """The corpus as (indptr, indices) pairs: graph i has
    nodes_per_graph·(0.5 + u) nodes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_graphs):
        n = int(nodes_per_graph * (0.5 + rng.random()))
        src, dst = _graph_edges(rng, n, avg_degree)
        out.append(csr_symmetric(src, dst, n))
    return out


def dataset_graph(num_nodes: int, avg_degree: int, seed: int):
    """One graph of exactly num_nodes nodes from the same edge model: the
    dataset whose nodes generation embeds."""
    src, dst = _graph_edges(np.random.default_rng(seed), num_nodes,
                            avg_degree)
    return csr_symmetric(src, dst, num_nodes)


def _digest(spec: dict) -> str:
    h = hashlib.sha256(json.dumps(spec, sort_keys=True).encode())
    with open(os.path.abspath(__file__), "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def ensure_corpus(spec: dict) -> str:
    """The corpus directory of ``spec`` (num_graphs, nodes_per_graph,
    avg_degree, seed), written on first use; returns its path."""
    path = os.path.join(CACHE_DIR, f"corpus-{_digest(spec)}")
    if os.path.exists(os.path.join(path, "manifest.json")):
        return path
    tmp = path + ".part"
    os.makedirs(tmp, exist_ok=True)
    entries = []
    for i, (indptr, indices) in enumerate(corpus_graphs(
            spec["num_graphs"], spec["nodes_per_graph"], spec["avg_degree"],
            spec["seed"])):
        np.save(os.path.join(tmp, f"g{i}.indptr.npy"), indptr)
        np.save(os.path.join(tmp, f"g{i}.indices.npy"), indices)
        entries.append({"name": f"g{i}", "num_nodes": len(indptr) - 1,
                        "num_edges": len(indices)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"version": 1, "graphs": entries}, f)
    os.replace(tmp, path)
    return path
