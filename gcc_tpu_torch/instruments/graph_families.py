"""Graph-classification transfer instrument
(``scripts/graph_benchmark.py``).

Six random-graph families at matched mean degree (~8) and overlapping
sizes (60-120 nodes), plus uniform noise edges, so that separating them
takes structure beyond size or mean degree:

  0 Erdos-Renyi            Poisson degrees, no structure
  1 Barabasi-Albert        heavy-tail degrees
  2 Watts-Strogatz         ring lattice + 20% rewire (high clustering)
  3 random regular         uniform degrees (vs ER: variance only)
  4 planted 2-partition    community structure at ER-like degrees
  5 Holme-Kim              BA + triad closure (heavy tail + clustering)

Frozen entire-graph readouts from one encode pass (the score readout,
the reference protocol, and the composite readout) are scored with the
reference's SVC(C=1e5) 10-fold protocol beside the degree-histogram
baseline, their concatenations with it and the majority floor.

The generators are the reference's byte for byte (the same
``default_rng`` calls in the same order, ``_regular``'s early return,
``_ba``'s list arithmetic, ``_holme_kim``'s dict order).
:func:`graph_readouts` runs on the card; :func:`score_graph_families`
needs scikit-learn.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np

from gcc_tpu_torch.graph.csr import CSRGraph

# sha256 of every graph's indices, concatenated, [:16], at 60 a family.
FAMILIES_HASH = "51a2967aad3ce4d2"


def _er(rng, n, d):
    p = d / (n - 1)
    m = rng.random((n, n)) < p
    src, dst = np.nonzero(np.triu(m, 1))
    return src, dst


def _ba(rng, n, m):
    targets = list(range(m))
    src, dst = [], []
    repeated = []
    for v in range(m, n):
        for t in targets:
            src.append(v)
            dst.append(t)
        repeated.extend(targets)
        repeated.extend([v] * m)
        targets = [repeated[i] for i in rng.integers(0, len(repeated), m)]
    return np.array(src), np.array(dst)


def _ws(rng, n, k, p):
    src, dst = [], []
    for v in range(n):
        for j in range(1, k // 2 + 1):
            u = (v + j) % n
            if rng.random() < p:
                u = int(rng.integers(0, n))
            if u != v:
                src.append(v)
                dst.append(u)
    return np.array(src), np.array(dst)


def _regular(rng, n, d):
    stubs = np.repeat(np.arange(n), d)
    for _ in range(10):
        rng.shuffle(stubs)
        src, dst = stubs[0::2], stubs[1::2]
        keep = src != dst
        if keep.mean() > 0.95:
            return src[keep], dst[keep]
    return src[keep], dst[keep]


def _planted(rng, n, d, ratio=3.0):
    half = n // 2
    blocks = (np.arange(n) >= half).astype(int)
    p_out = 2 * d / (n * (1 + ratio))
    p_in = ratio * p_out
    m = rng.random((n, n))
    same = blocks[:, None] == blocks[None, :]
    adj = np.where(same, m < p_in, m < p_out)
    src, dst = np.nonzero(np.triu(adj, 1))
    return src, dst


def _holme_kim(rng, n, m, p_triad=0.5):
    src, dst = _ba(rng, n, m)
    # triad closure: for a fraction of edges, connect a random neighbor
    # pair of the same hub.
    extra_s, extra_d = [], []
    by_node: dict[int, list[int]] = {}
    for s, t in zip(src, dst):
        by_node.setdefault(int(t), []).append(int(s))
    for hub, nbrs in by_node.items():
        if len(nbrs) >= 2:
            for _ in range(int(len(nbrs) * p_triad)):
                a, b = rng.integers(0, len(nbrs), 2)
                if nbrs[a] != nbrs[b]:
                    extra_s.append(nbrs[a])
                    extra_d.append(nbrs[b])
    return (np.concatenate([src, extra_s]).astype(np.int64),
            np.concatenate([dst, extra_d]).astype(np.int64))


def build_graph_benchmark(graphs_per_class=60, seed=0, p_noise=0.05):
    """(graphs, labels): six families, matched mean degree ~8, sizes
    60-120, + `p_noise`·E uniform noise edges per graph."""
    rng = np.random.default_rng(seed)
    gens = [
        lambda n: _er(rng, n, 8),
        lambda n: _ba(rng, n, 4),
        lambda n: _ws(rng, n, 8, 0.2),
        lambda n: _regular(rng, n, 8),
        lambda n: _planted(rng, n, 8),
        lambda n: _holme_kim(rng, n, 3),
    ]
    graphs, labels = [], []
    for cls, gen in enumerate(gens):
        for _ in range(graphs_per_class):
            n = int(rng.integers(60, 121))
            src, dst = gen(n)
            e_noise = max(1, int(p_noise * len(src)))
            ns = rng.integers(0, n, e_noise)
            nd = rng.integers(0, n, e_noise)
            keep = ns != nd
            src = np.concatenate([src, ns[keep]])
            dst = np.concatenate([dst, nd[keep]])
            graphs.append(CSRGraph.from_edges(src, dst, num_nodes=n,
                                              symmetrize=True))
            labels.append(cls)
    return graphs, np.array(labels)


def degree_histogram_embeddings(graphs, bins=16):
    """Strongest trivial baseline: normalized log-binned degree
    histogram + [n, e, mean_deg] summary stats."""
    out = np.zeros((len(graphs), bins + 3), np.float64)
    edges = np.unique(np.geomspace(1, 256, bins + 1).astype(int))
    for i, g in enumerate(graphs):
        deg = np.diff(g.indptr)
        h, _ = np.histogram(deg, bins=edges)
        out[i, : len(h)] = h / max(1, len(deg))
        out[i, -3:] = [g.num_nodes / 128.0, g.num_edges / 1024.0,
                       deg.mean() / 16.0]
    return out


def families_hash(graphs) -> str:
    """The fixture's content hash as the tests pin it."""
    return hashlib.sha256(
        b"".join(g.indices.tobytes() for g in graphs)).hexdigest()[:16]


def graph_readouts(cfg, state, graphs, n_max: int = 256, e_max: int = 8192,
                   device="cuda"):
    """One entire-graph encode pass serving both readouts
    (``graph_benchmark.py:185-189``): ({"score": (G, out), "composite":
    (G, F)}, {"encode_s": wall})."""
    from gcc_tpu_torch.generate import (
        composite_graph_readout,
        generate_graph_readouts,
    )

    t0 = time.perf_counter()
    ro = generate_graph_readouts(cfg, state, graphs, n_max=n_max,
                                 e_max=e_max, device=device)
    out = {"score": ro["score"], "composite": composite_graph_readout(ro)}
    return out, {"encode_s": time.perf_counter() - t0}


def score_graph_families(score: np.ndarray, composite: np.ndarray,
                         graphs, y: np.ndarray) -> dict:
    """The reference's rows (``graph_benchmark.py:190-203``) — gcc (the
    score readout), gcc-composite, degree-hist, gcc+dh, composite+dh —
    each also with per-fold standardization (``/std``, the scaler fit on
    each fold's train rows), and the majority floor. Needs scikit-learn."""
    from gcc_tpu_torch.tasks import evaluate_graph_embeddings

    dh = degree_histogram_embeddings(graphs)
    rows = {"gcc": score, "gcc-composite": composite, "degree-hist": dh,
            "gcc+dh": np.concatenate([score, dh], axis=1),
            "composite+dh": np.concatenate([composite, dh], axis=1)}
    results = {}
    for std in (False, True):
        for name, emb in rows.items():
            results[name + ("/std" if std else "")] = \
                evaluate_graph_embeddings(emb, y, standardize=std)
    counts = np.bincount(y)
    results["majority"] = {"Micro-F1": float(counts.max() / counts.sum())}
    return results
