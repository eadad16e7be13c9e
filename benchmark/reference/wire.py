"""The sampler's wire as plain graphs, and the E2E size split's slotting.

A stacked compact wire row holds B graphs: meta (3, B) rows n_nodes,
n_edges, seed position; edges packed ``src | dst << id_bits``, graph j
owning the slots [cum_j - e_j, cum_j).
"""

from __future__ import annotations

import numpy as np
import torch


def row_graphs(edges_row, meta_row, id_bits: int):
    """[(src, dst, n_nodes, seed)] of one wire row."""
    e = np.asarray(edges_row).astype(np.int64)
    meta = np.asarray(meta_row).astype(np.int64)
    mask = (1 << id_bits) - 1
    cum = np.cumsum(meta[1])
    start = cum - meta[1]
    return [((e[a:b] & mask), ((e[a:b] >> id_bits) & mask), int(n), int(s))
            for a, b, n, s in zip(start, cum, meta[0], meta[2])]


def dense(graphs, n_b: int, device):
    """(adj, node_mask, seed_flag, n_nodes) of graphs in an n_b bucket:
    A[dst, src] counts edges with both ends below n_b; a node is real
    below the graph's own count (which may pass n_b when the size split
    forces a pair into a smaller bucket)."""
    adj = np.zeros((len(graphs), n_b, n_b), np.float32)
    for g, (src, dst, _, _) in enumerate(graphs):
        keep = (src < n_b) & (dst < n_b)
        np.add.at(adj[g], (dst[keep], src[keep]), 1.0)
    n_nodes = torch.tensor([g[2] for g in graphs], dtype=torch.int64,
                           device=device)
    seed = torch.tensor([g[3] for g in graphs], dtype=torch.int64,
                        device=device)
    iota = torch.arange(n_b, device=device)
    node_mask = (iota[None, :] < n_nodes[:, None]).to(torch.float32)
    seed_flag = (iota[None, :] == seed[:, None]).to(torch.float32) * node_mask
    return torch.from_numpy(adj).to(device), node_mask, seed_flag, n_nodes


def split_classes(spec: str, batch: int, n_max: int):
    """[(bucket, slots)] of an E2E split spec "n0:c0,n1:c1" closed by
    (n_max, the rest of the batch)."""
    classes = [tuple(int(x) for x in part.split(":"))
               for part in spec.split(",")]
    return classes + [(n_max, batch - sum(c for _, c in classes))]


def split_order(n_q, n_k, classes) -> np.ndarray:
    """Slot order of one step's pairs: a pair's class is the first bucket
    holding both views (the larger count), slots filled in class order,
    pairs of one class in batch order."""
    mx = np.maximum(np.asarray(n_q), np.asarray(n_k))
    cls = np.zeros_like(mx)
    for n_b, _ in classes[:-1]:
        cls += (mx > n_b)
    return np.argsort(cls, kind="stable")
