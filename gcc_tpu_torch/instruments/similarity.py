"""Similarity-search instrument (``scripts/sim_benchmark.py``).

The reference task re-identifies the same authors across two co-author
graphs by structure alone. The synthetic analog: one heavy-tailed base
graph, two independently perturbed views (each rewires a fraction of
edge endpoints), the node ids of view 2 shuffled; the hidden
correspondence is the ground truth, scored by the reference's
``evaluate_similarity`` (L2-normalize, dot-product ranking, Recall@20 and
@40). Rows: GCC's score embedding, the node-level composite readout
(``(q + k) / 2`` of ``composite_graph_readout`` over the two views),
5-d degree features, GraphWave, ProNE (axes not aligned across runs:
near chance by design), the composite + degree-feature probe, chance.

The generators are the reference's byte for byte.
:func:`sim_embeddings` runs on the card; :func:`score_similarity` needs
scikit-learn (ProNE's randomized SVD).
"""

from __future__ import annotations

import hashlib
import time

import numpy as np

from gcc_tpu_torch.graph.csr import CSRGraph

# The calibrated rewiring (sim_benchmark.py's default: GCC R@20 ~0.22-0.24,
# chance 0.02, the baselines separated).
REWIRE = 0.05
# sha256 of (g1.indptr, g1.indices, g2.indptr, g2.indices, view 2's
# permutation as int64)[:16] at n=1000, rewire=REWIRE.
SIM_HASH = "0a9c1af5af7ce34c"


def _base_edges(rng, n, m):
    """Heavy-tailed base graph (same family as the bench corpus): node
    identities get distinctive degrees/neighborhoods."""
    src = (n * rng.random(m) ** 2.0).astype(np.int64)
    dst = rng.integers(0, n, m)
    keep = src != dst
    return src[keep], dst[keep]


def _perturb(rng, src, dst, n, p):
    """Rewire one endpoint of a fraction p of edges (independent noise
    per view)."""
    src, dst = src.copy(), dst.copy()
    hit = rng.random(src.shape[0]) < p
    new_dst = rng.integers(0, n, hit.sum())
    dst[hit] = new_dst
    keep = src != dst
    return src[keep], dst[keep]


def build_sim_pair(n=2000, avg_degree=8, rewire=0.2, seed=0):
    """(g1, g2, dict_1, dict_2): two independently perturbed views of
    one base graph; dict_i maps shared-name -> node index (view 2 is
    id-shuffled so embeddings cannot cheat off index order)."""
    rng = np.random.default_rng(seed)
    m = n * avg_degree // 2
    src, dst = _base_edges(rng, n, m)
    s1, d1 = _perturb(rng, src, dst, n, rewire)
    s2, d2 = _perturb(rng, src, dst, n, rewire)
    perm = rng.permutation(n)
    g1 = CSRGraph.from_edges(s1, d1, num_nodes=n, symmetrize=True)
    g2 = CSRGraph.from_edges(perm[s2], perm[d2], num_nodes=n,
                             symmetrize=True)
    dict_1 = {i: i for i in range(n)}
    dict_2 = {i: int(perm[i]) for i in range(n)}
    return g1, g2, dict_1, dict_2


def degree_feature_embeddings(g) -> np.ndarray:
    """5-d handcrafted structural features (id-shuffle invariant)."""
    deg = np.diff(g.indptr).astype(np.float64)
    row = np.repeat(np.arange(g.num_nodes), np.diff(g.indptr))
    nbr_deg = deg[g.indices]
    nbr_deg_sum = np.bincount(row, weights=nbr_deg, minlength=g.num_nodes)
    mean_nbr = nbr_deg_sum / np.maximum(deg, 1)
    max_nbr = np.zeros_like(deg)
    np.maximum.at(max_nbr, row, nbr_deg)
    two_hop = nbr_deg_sum  # Σ neighbor degrees ≈ 2-hop ball size
    out = np.stack([
        np.log1p(deg), np.log1p(mean_nbr), np.log1p(max_nbr),
        np.log1p(two_hop), np.sqrt(deg),
    ], axis=1)
    return out


def correspondence(dict_1: dict, dict_2: dict, n: int):
    """The two name -> node maps as (n,) int64 arrays (names 0..n-1)."""
    return (np.array([dict_1[i] for i in range(n)], np.int64),
            np.array([dict_2[i] for i in range(n)], np.int64))


def sim_hash(g1: CSRGraph, g2: CSRGraph, corr_2: np.ndarray) -> str:
    """The fixture's content hash as the tests pin it."""
    return hashlib.sha256(
        g1.indptr.tobytes() + g1.indices.tobytes() + g2.indptr.tobytes()
        + g2.indices.tobytes()
        + np.asarray(corr_2, np.int64).tobytes()).hexdigest()[:16]


def sim_embeddings(cfg, state, graphs, n_max: int = 256, e_max: int = 2048,
                   device="cuda"):
    """For each graph: the score embedding of every node (two RWR views,
    ``(q + k) / 2``) and the node-level composite readout averaged over
    the same two views (``sim_benchmark.py:152-169``). Returns (scores,
    composites, {"sample_s", "encode_s"})."""
    from gcc_tpu_torch.generate import (
        composite_graph_readout,
        generate_embeddings,
        generate_subgraph_readouts,
        node_subgraphs,
    )

    embs, comps, sample_s, encode_s = [], [], 0.0, 0.0
    kw = dict(n_max=n_max, e_max=e_max, device=device)
    for g in graphs:
        t0 = time.perf_counter()
        subs_q, subs_k = node_subgraphs(g, cfg, n_max, e_max, two_views=True)
        t1 = time.perf_counter()
        embs.append(generate_embeddings(cfg, state, subs_q,
                                        subgraphs_k=subs_k, **kw))
        ro_q = generate_subgraph_readouts(cfg, state, subs_q, **kw)
        ro_k = generate_subgraph_readouts(cfg, state, subs_k, **kw)
        comps.append((composite_graph_readout(ro_q)
                      + composite_graph_readout(ro_k)) / 2.0)
        sample_s += t1 - t0
        encode_s += time.perf_counter() - t1
    return embs, comps, {"sample_s": sample_s, "encode_s": encode_s}


def _unit(x):
    m = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.where(m == 0, 1.0, m)


def score_similarity(embs, comps, g1: CSRGraph, g2: CSRGraph, dict_1: dict,
                     dict_2: dict) -> dict:
    """The reference's rows (``sim_benchmark.py:170-192``). The two
    baselines that train a model (GraphWave, ProNE, 64-d) record their
    error in their row instead of sinking the instrument, as the reference
    does. Needs scikit-learn."""
    from gcc_tpu_torch.models.emb import build_model
    from gcc_tpu_torch.tasks.similarity_search import evaluate_similarity

    n = g1.num_nodes
    results = {"gcc": evaluate_similarity(embs[0], embs[1], dict_1, dict_2)}
    results["gcc-composite"] = evaluate_similarity(comps[0], comps[1],
                                                   dict_1, dict_2)
    df1, df2 = degree_feature_embeddings(g1), degree_feature_embeddings(g2)
    results["degree-feat"] = evaluate_similarity(df1, df2, dict_1, dict_2)
    for name in ("graphwave", "prone"):
        try:
            model = build_model(name, 64)
            results[name] = evaluate_similarity(model.train(g1),
                                                model.train(g2), dict_1,
                                                dict_2)
        except Exception as e:  # baselines must not sink the instrument
            results[name] = {"error": f"{type(e).__name__}: {e}"}
    results["composite+degfeat"] = evaluate_similarity(
        np.concatenate([_unit(comps[0]), _unit(df1)], axis=1),
        np.concatenate([_unit(comps[1]), _unit(df2)], axis=1), dict_1,
        dict_2)
    results["chance"] = {f"Recall @ {k}": k / n for k in (20, 40)}
    return results
