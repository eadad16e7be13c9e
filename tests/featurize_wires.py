"""Compact wires on which Kernel 1's degrees must come from the stored
entries (a bf16 count stops at 256): numpy arrays (edges (S, E_tot)
int32, meta (S, 3, B) int32, n_max, id_bits), shared by the CPU tests and
the card tests (this module imports neither JAX nor a card)."""

import numpy as np


def heavy_wire():
    """One 400-node graph in the 512 bucket (16-bit ids) with in-degrees
    of 301 and 259 from distinct sources (bf16 sums 300 and 260) and a
    pair repeated 300 times (a bf16 count stops at 256), beside a graph
    with no edges."""
    src = np.concatenate([np.arange(1, 302), np.arange(4, 263),
                          np.full(300, 2), np.arange(5, 40)])
    dst = np.concatenate([np.zeros(301, int), np.full(259, 3),
                          np.full(300, 1), np.arange(6, 41)])
    packed = src.astype(np.int64) | (dst.astype(np.int64) << 16)
    edges = np.zeros((1, 1024), np.int32)
    edges[0, :packed.size] = packed
    meta = np.zeros((1, 3, 2), np.int32)
    meta[0, :, 0] = [400, packed.size, 0]
    meta[0, :, 1] = [10, 0, 3]
    return edges, meta, 512, 16


def pair_wire_256(seed: int = 0):
    """The 256 bucket with 8-bit ids, one segment of three graphs: a
    256-node graph where (1 <- 2) and id 255's self loop each repeat 300
    times (stored 256 in bf16), node 0 is fed by 255 distinct sources and
    node 3 by all 256 and by 9 forty times more (in-degree 296, no entry
    past 256); a 200-node graph of 100 random undirected edges; a 50-node
    graph with no edges."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.arange(1, 256), np.full(300, 2),
                          np.arange(0, 256), np.full(40, 9),
                          np.full(300, 255)])
    dst = np.concatenate([np.zeros(255, int), np.full(300, 1),
                          np.full(256, 3), np.full(40, 3),
                          np.full(300, 255)])
    u, v = rng.integers(0, 200, 100), rng.integers(0, 200, 100)
    runs = [src | (dst << 8), np.stack([u | (v << 8), v | (u << 8)],
                                       1).ravel()]
    packed = np.concatenate(runs)
    edges = np.full((1, packed.size + 64), 0xFFFF, np.int32)
    edges[0, :packed.size] = packed
    meta = np.zeros((1, 3, 3), np.int32)
    meta[0, 0] = [256, 200, 50]
    meta[0, 1] = [runs[0].size, runs[1].size, 0]
    meta[0, 2] = [255, 7, 0]
    return edges, meta, 256, 8
