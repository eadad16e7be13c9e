"""Kernel 1, the fused featurize builder: packed edges and per-graph meta
in; the adjacency, the shifted normalized operator m_shift and the
degrees out (float32), for each graph at its real n nodes and e edges.

Bytes: 4 a packed edge (int32 on the device) and 12 of meta a graph with
nodes read;
n² values of the adjacency and n² of m_shift and n degrees written.
Operations: 3 an entry of the operator (two scalings and the shift)."""

from __future__ import annotations

import numpy as np


def work(n_nodes, n_edges) -> dict:
    n = np.asarray(n_nodes, np.float64)
    e = np.asarray(n_edges, np.float64)
    return {"f32": float(np.sum(3.0 * n * n)), "bf16": 0.0,
            "bytes": float(np.sum(4.0 * e + 12.0 * (n > 0) + 8.0 * n * n
                                  + 4.0 * n))}
