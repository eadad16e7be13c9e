"""The counted work of whole steps and calls: the featurize kernels and
the encoder, at each graph's real nodes and edges."""

from __future__ import annotations

import numpy as np

from benchmark.counts import encoder, kernel1, kernel2, kernel3
from benchmark.counts.bound import total


def featurize(n_nodes, n_edges, pos: int, guards: int, compact: bool):
    """Work of the kernels that featurize one batch of graphs: Kernel 1
    where the batch is built from the packed wire, Kernel 2 at the block
    width pos + guards (even, at most the bucket), and Kernel 3 once at
    that width, twice with guards (the whitening and the Rayleigh-Ritz),
    a matrix a graph with nodes (an empty slot of a batch needs none).
    Returns {kernel: work}."""
    n_nodes = np.asarray(n_nodes)
    k = pos + guards
    graphs = int(np.count_nonzero(n_nodes))
    out = {"kernel2": kernel2.work(n_nodes, k),
           "kernel3": kernel3.work(k, graphs * (2 if guards else 1))}
    if compact:
        out["kernel1"] = kernel1.work(n_nodes, n_edges)
    return out


def operations(works) -> float:
    t = total(works)
    return t["f32"] + t["bf16"]


def train_ops(q, k, cfg: dict, candidates: int, trained_keys: bool) -> float:
    """Operations of one contrastive step on query views q and key views k
    ((n_nodes, n_edges) arrays): the query encoder's forward and backward,
    the key forward (and backward where the key encoder trains, E2E), the
    logits' forward and backward against ``candidates`` per query."""
    fq = encoder.forward(q[0], q[1], cfg)
    fk = encoder.forward(k[0], k[1], cfg)
    lg = encoder.logits(len(q[0]), candidates, cfg["output_size"])
    return 3.0 * fq + (3.0 if trained_keys else 1.0) * fk + 3.0 * lg
