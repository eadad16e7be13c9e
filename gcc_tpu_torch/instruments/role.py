"""Structural-role transfer instrument (``scripts/role_benchmark.py``).

GCC's claim is that pre-trained structural embeddings transfer to graphs
the corpus never held. The role graphs' labels are pure local-structure
roles: v1 (:func:`build_role_graph`, 2 classes: clique members against
star centers and satellites, saturated) and v2
(:func:`build_role_graph_v2`, 9 role families with overlapping degrees
and per-node noise edges, sub-ceiling). Frozen GCC embeddings of every
node (two RWR views, ``(q + k) / 2``) are scored against ProNE /
GraphWave / Zero trained on the eval graph itself, by the reference's
LogReg 10-fold protocol.

The generators are the reference's byte for byte: the same
``default_rng`` calls in the same order, so the port's fixtures hash to
the values ``tests/test_benchmark_instruments.py`` pins.
:func:`role_embeddings` runs on the card; :func:`score_role` needs
scikit-learn, which the card's machine lacks.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np

from gcc_tpu_torch.graph.csr import CSRGraph

# sha256(indptr || indices)[:16] of the v2 graph at its defaults (6,307
# nodes) and at the finetune instrument's blocks=60 (3,132 nodes).
ROLE_V2_HASH = "fcf2d5d7f2d77871"
ROLE_V2_60_HASH = "10a9ec75cb0e9f7d"


def build_role_graph(num_motifs=60, seed=0):
    """Interleaved cliques and stars with sparse random inter-links."""
    rng = np.random.default_rng(seed)
    src, dst, labels = [], [], []
    base = 0
    for i in range(num_motifs):
        if i % 2 == 0:  # 6-clique, role 1
            ids = np.arange(base, base + 6)
            for a in range(6):
                for b in range(a + 1, 6):
                    src.append(ids[a]); dst.append(ids[b])
            labels.extend([1] * 6)
            base += 6
        else:           # star: center + 6 satellites, role 0
            center = base
            sats = np.arange(base + 1, base + 7)
            for s in sats:
                src.append(center); dst.append(s)
            # chain satellites lightly so their degree ~2-3 (no triangles)
            for j in range(len(sats) - 1):
                if rng.random() < 0.5:
                    src.append(sats[j]); dst.append(sats[j + 1])
            labels.extend([0] * 7)
            base += 7
    n = base
    # sparse random inter-motif links to connect the graph
    for _ in range(num_motifs):
        a, b = rng.integers(0, n, 2)
        if a != b:
            src.append(int(a)); dst.append(int(b))
    g = CSRGraph.from_edges(np.array(src), np.array(dst), num_nodes=n,
                            symmetrize=True)
    y = np.zeros((n, 2), np.float32)
    y[np.arange(n), labels] = 1
    return g, y


def build_role_graph_v2(blocks=120, p_noise=0.25, label_noise=0.0, seed=0):
    """Sub-ceiling 9-class structural-role graph: 9 role families whose
    degrees overlap, plus per-node noise edges (probability ``p_noise``).

      0 clique member        K_k, k in {5,6,7}        deg 4-6, triangles
      1 bipartite-core       K_{a,b}, a,b in {3,4}    deg 3-4, no tris
      2 star center          s in {5..8} satellites   deg 5-8
      3 star satellite       deg 1 (+chain links)
      4 cycle node           L in {6..10}             deg 2
      5 chain node           L in {6..10}             deg 1-2
      6 tree internal        binary, depth 2          deg 2-3
      7 tree leaf            deg 1
      8 grid node            3x3 lattice              deg 2-4, squares

    ~51 nodes a block; blocks=120 gives 6,307 nodes. Returns (CSRGraph,
    one-hot labels). ``label_noise`` flips that fraction of labels to a
    random other class (default off)."""
    rng = np.random.default_rng(seed)
    src, dst, labels = [], [], []
    base = 0

    def add(a, b):
        src.append(int(a)); dst.append(int(b))

    for _ in range(blocks):
        # clique
        k = int(rng.integers(5, 8))
        ids = range(base, base + k)
        for i in ids:
            for j in ids:
                if i < j:
                    add(i, j)
        labels.extend([0] * k)
        base += k
        # bipartite core K_{a,b}
        a, b = int(rng.integers(3, 5)), int(rng.integers(3, 5))
        left = list(range(base, base + a))
        right = list(range(base + a, base + a + b))
        for i in left:
            for j in right:
                add(i, j)
        labels.extend([1] * (a + b))
        base += a + b
        # star: center + satellites, light satellite chaining
        s = int(rng.integers(5, 9))
        center = base
        sats = list(range(base + 1, base + 1 + s))
        for t in sats:
            add(center, t)
        for j in range(s - 1):
            if rng.random() < 0.4:
                add(sats[j], sats[j + 1])
        labels.extend([2] + [3] * s)
        base += 1 + s
        # cycle
        lc = int(rng.integers(6, 11))
        for i in range(lc):
            add(base + i, base + (i + 1) % lc)
        labels.extend([4] * lc)
        base += lc
        # chain (open path, same length range as cycle)
        lp = int(rng.integers(6, 11))
        for i in range(lp - 1):
            add(base + i, base + i + 1)
        labels.extend([5] * lp)
        base += lp
        # binary tree depth 2: root, 2 internals, 4 leaves
        root = base
        i1, i2 = base + 1, base + 2
        add(root, i1); add(root, i2)
        for li, parent in enumerate((i1, i1, i2, i2)):
            add(parent, base + 3 + li)
        labels.extend([6] * 3 + [7] * 4)
        base += 7
        # 3x3 grid
        g0 = base
        for r in range(3):
            for c in range(3):
                if c < 2:
                    add(g0 + 3 * r + c, g0 + 3 * r + c + 1)
                if r < 2:
                    add(g0 + 3 * r + c, g0 + 3 * (r + 1) + c)
        labels.extend([8] * 9)
        base += 9

    n = base
    # Per-node noise edges: blur local structure graph-wide.
    for v in range(n):
        if rng.random() < p_noise:
            u = int(rng.integers(0, n))
            if u != v:
                add(v, u)

    g = CSRGraph.from_edges(np.array(src), np.array(dst), num_nodes=n,
                            symmetrize=True)
    labels = np.asarray(labels)
    if label_noise > 0:
        flip = rng.random(n) < label_noise
        labels = labels.copy()
        labels[flip] = (labels[flip]
                        + rng.integers(1, 9, flip.sum())) % 9
    y = np.zeros((n, 9), np.float32)
    y[np.arange(n), labels] = 1
    return g, y


def role_hash(g: CSRGraph) -> str:
    """The fixture's content hash as the tests pin it."""
    return hashlib.sha256(g.indptr.tobytes()
                          + g.indices.tobytes()).hexdigest()[:16]


def role_embeddings(cfg, state, g: CSRGraph, n_max: int = 256,
                    e_max: int = 2048, device="cuda"):
    """Frozen GCC embeddings of every node of ``g``: two RWR views a node,
    encoded in eval mode, ``(q + k) / 2`` (``role_benchmark.py:223-226``).
    ``state``: the port's encoder or a PretrainState. Returns (embeddings,
    {"sample_s": host sampling wall, "encode_s": encode wall})."""
    from gcc_tpu_torch.generate import generate_embeddings, node_subgraphs

    t0 = time.perf_counter()
    subs_q, subs_k = node_subgraphs(g, cfg, n_max, e_max, two_views=True)
    t1 = time.perf_counter()
    emb = generate_embeddings(cfg, state, subs_q, n_max=n_max, e_max=e_max,
                              subgraphs_k=subs_k, device=device)
    return emb, {"sample_s": t1 - t0, "encode_s": time.perf_counter() - t1}


def score_role(emb: np.ndarray, g: CSRGraph, y: np.ndarray) -> dict:
    """{gcc, prone, graphwave, zero}: each embedding's 10-fold LogReg
    micro-F1 on the role labels; the three baselines are trained on ``g``
    at GCC's width (``role_benchmark.py:227-232``). Needs scikit-learn."""
    from gcc_tpu_torch.models.emb import build_model
    from gcc_tpu_torch.tasks import evaluate_node_embeddings

    results = {"gcc": evaluate_node_embeddings(emb, y)}
    for name in ("prone", "graphwave", "zero"):
        model = build_model(name, emb.shape[1])
        results[name] = evaluate_node_embeddings(model.train(g), y)
    return results
