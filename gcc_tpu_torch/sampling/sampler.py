"""High-level subgraph samplers (host side).

Reproduces the reference's query/key pair construction
(gcc/datasets/graph_dataset.py:94-179): a query subgraph from an RWR
rooted at the seed, a key subgraph from an independent RWR rooted at a
seed reached by a `step_dist`-distributed plain random walk (0 hops by
default, i.e. the same node), both with the per-seed visit budget

    max(rw_hops, round(deg(seed)^0.75 * e/(e-1) / restart_prob))

(graph_dataset.py:113-124). Entire-graph mode (graph classification)
skips sampling and featurizes the whole graph with the seed flag on the
max-out-degree node (graph_dataset.py:327-339).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from gcc_tpu_torch.config import SamplerConfig
from gcc_tpu_torch.graph.batch import Subgraph
from gcc_tpu_torch.graph.csr import CSRGraph
from gcc_tpu_torch.sampling import native


def rwr_budgets(
    g: CSRGraph, seeds: np.ndarray, cfg: SamplerConfig, degree_power: bool = True
) -> np.ndarray:
    """Per-seed visit budgets.

    degree_power=True uses the LoadBalance corpus variant deg^0.75
    (reference graph_dataset.py:113-124); False uses the raw out-degree
    variant of the map-style datasets (graph_dataset.py:243-254).
    """
    seeds = np.asarray(seeds, np.int64)
    # O(len(seeds)) degree lookup — np.diff over the whole indptr is
    # O(num_nodes) and this sits on the per-step sampling hot path.
    deg = (g.indptr[seeds + 1] - g.indptr[seeds]).astype(np.float64)
    if degree_power:
        deg = deg ** 0.75
    scaled = np.floor(
        deg * math.e / (math.e - 1.0) / cfg.restart_prob + 0.5
    ).astype(np.int64)
    return np.maximum(cfg.rw_hops, scaled)


def _key_seeds(
    g: CSRGraph, seeds: np.ndarray, cfg: SamplerConfig, rng_seed: int,
    sample_ids: np.ndarray, force_numpy: bool,
) -> np.ndarray:
    """Pick the key-view seed per query seed via step_dist walk (N3)."""
    if len(cfg.step_dist) == 0 or cfg.step_dist[0] == 1.0:
        return np.asarray(seeds, np.int64)
    # Salt the stream with the sample ids so the hop-count draw is fresh
    # per sample (the reference draws per __getitem__), not frozen
    # per-shard.
    rng = np.random.default_rng((rng_seed, 0x5EED, int(sample_ids[0])))
    steps = rng.choice(len(cfg.step_dist), size=len(seeds), p=cfg.step_dist)
    out = np.asarray(seeds, np.int64).copy()
    for hop in np.unique(steps):
        if hop == 0:
            continue
        mask = steps == hop
        out[mask] = native.random_walk_final(
            g, out[mask], int(hop), rng_seed=rng_seed,
            sample_ids=sample_ids[mask], force_numpy=force_numpy,
        )
    return out


def sample_contrastive_pairs(
    g: CSRGraph,
    seeds: np.ndarray,
    cfg: SamplerConfig,
    **kwargs,
) -> tuple[list[Subgraph], list[Subgraph]]:
    """Sample (query, key) subgraph pairs for contrastive pre-training.

    The key view uses an independent RNG stream (different sample id
    space) so q/k are two different random subgraphs even when rooted at
    the same seed — this is the augmentation that makes InfoNCE
    non-trivial (reference samples two traces in one RWR call,
    graph_dataset.py:125-130). List-of-Subgraph convenience wrapper over
    :func:`sample_contrastive_pairs_raw`.
    """
    out_q, out_k = sample_contrastive_pairs_raw(g, seeds, cfg, **kwargs)
    return _to_subgraphs(out_q), _to_subgraphs(out_k)


def sample_contrastive_pairs_raw(
    g: CSRGraph,
    seeds: np.ndarray,
    cfg: SamplerConfig,
    rng_seed: int = 0,
    sample_ids: np.ndarray | None = None,
    degree_power: bool = True,
    n_threads: int = 1,
    force_numpy: bool = False,
    node_cap: int | None = None,
    e_cap: int | None = None,
) -> tuple[native.SampledSubgraphs, native.SampledSubgraphs]:
    """Like :func:`sample_contrastive_pairs` but returns the native
    sampler's padded array form directly — zero per-graph Python work,
    ready for the pipeline's wire buffers (sampling/pipeline.py)."""
    seeds = np.asarray(seeds, np.int64)
    s = len(seeds)
    if sample_ids is None:
        sample_ids = np.arange(s, dtype=np.int64)
    k_seeds = _key_seeds(g, seeds, cfg, rng_seed, sample_ids, force_numpy)
    budgets_q = rwr_budgets(g, seeds, cfg, degree_power)
    budgets_k = rwr_budgets(g, k_seeds, cfg, degree_power)
    if node_cap is None:
        node_cap = int(max(budgets_q.max(initial=1), budgets_k.max(initial=1))) + 1
    common = dict(
        restart_prob=cfg.restart_prob, aug=cfg.aug, expand=cfg.num_neighbors,
        hops=cfg.rw_hops, rng_seed=rng_seed, node_cap=node_cap, e_cap=e_cap,
        n_threads=n_threads, force_numpy=force_numpy,
    )
    out_q = native.sample_subgraphs(
        g, seeds, budgets_q, sample_ids=2 * sample_ids, **common
    )
    out_k = native.sample_subgraphs(
        g, k_seeds, budgets_k, sample_ids=2 * sample_ids + 1, **common
    )
    return out_q, out_k


def _to_subgraphs(s: native.SampledSubgraphs) -> list[Subgraph]:
    out = []
    for i in range(len(s.n)):
        n_i, e_i = int(s.n[i]), int(s.e[i])
        out.append(
            Subgraph(
                src=s.src[i, :e_i].copy(),
                dst=s.dst[i, :e_i].copy(),
                num_nodes=n_i,
                seed=0,
            )
        )
    return out


def entire_graph_subgraph(g: CSRGraph) -> Subgraph:
    """Whole-graph 'subgraph' with seed = max-out-degree node (N4 bypass)."""
    degrees = np.diff(g.indptr)
    src = np.repeat(np.arange(g.num_nodes, dtype=np.int32), degrees)
    return Subgraph(
        src=src,
        dst=g.indices.astype(np.int32),
        num_nodes=g.num_nodes,
        seed=int(np.argmax(degrees)),
    )


def degree_weights(graphs: Sequence[CSRGraph], power: float = 0.75) -> np.ndarray:
    """Concatenated deg^power seed-sampling weights over a graph list
    (reference graph_dataset.py:86-92)."""
    return np.concatenate(
        [np.diff(g.indptr).astype(np.float64) ** power for g in graphs]
    )
