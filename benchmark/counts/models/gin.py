"""Operations of the GIN encoder (GCC's default: 5 layers, hidden 64) for
a batch of graphs at their real n nodes and e edges (multi-edges counted).

A forward, per graph: for each conv layer with f inputs, the aggregation
A·h (2·e·f) and the residual sum (n·f), Linear0 (2·n·f·h), Linear1
(2·n·h·h); for each of the L readouts the sum pool (n·f) and its Linear
(2·f·o, for a graph with nodes). Element-wise terms of order n·h
(BatchNorm, ReLU, dropout, bias) are left out: they are under a tenth of
the products at h = 64."""

from __future__ import annotations

import numpy as np


def forward(n_nodes, n_edges, cfg: dict) -> float:
    n = np.asarray(n_nodes, np.float64)
    e = np.asarray(n_edges, np.float64)
    h = cfg["hidden_size"]
    o = cfg["output_size"]
    f0 = cfg["positional_embedding_size"] + cfg["degree_embedding_size"] + 1
    dims = [f0] + [h] * (cfg["num_layers"] - 1)
    ops = np.zeros_like(n)
    for f in dims[:-1]:
        ops += 2.0 * e * f + n * f + 2.0 * n * f * h + 2.0 * n * h * h
    for f in dims:
        ops += n * f + 2.0 * f * o * (n > 0)
    return float(np.sum(ops))

