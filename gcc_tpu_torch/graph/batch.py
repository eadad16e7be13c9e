"""Host-side wire types for subgraph batches (numpy only).

The sampler ships batches in a compact form — per-graph edge runs
concatenated into one packed buffer plus three small per-graph vectors —
and everything else (adjacency, node mask, seed one-hot, degrees, PE) is
derived on the device (``gcc_tpu_torch/features``). ``wire.py`` moves
these arrays onto the device.

Evaluation (embedding generation) batches arbitrary host subgraphs
instead: :func:`batch_subgraphs` pads them into a
:class:`PaddedSubgraphBatch` of one (N_max, E_max) bucket, still numpy;
``features.featurize_batch`` uploads it.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class PaddedSubgraphBatch:
    """A batch of B subgraphs padded to static (N_max, E_max), numpy on
    the host (``gcc_tpu/graph/batch.py:32-62``).

    The B subgraphs live in a flat node space of size B·N_max (graph b's
    node i at flat index b·N_max + i).

      edges_src, edges_dst: (B·E_max,) int32 flat node index per edge.
      edge_weight: (B·E_max,) float32 — 1.0 real / 0.0 padding.
      node_mask: (B, N_max) float32 — 1.0 real node / 0.0 padding.
      seed_flag: (B, N_max) float32 — one-hot seed indicator.
      n_nodes: (B,) int32 — real node count per subgraph.
    """

    edges_src: np.ndarray
    edges_dst: np.ndarray
    edge_weight: np.ndarray
    node_mask: np.ndarray
    seed_flag: np.ndarray
    n_nodes: np.ndarray

    @property
    def batch_size(self) -> int:
        return self.node_mask.shape[0]

    @property
    def n_max(self) -> int:
        return self.node_mask.shape[1]

    @property
    def e_max(self) -> int:
        return self.edges_src.shape[0] // self.node_mask.shape[0]


# Bucket ladders. Powers of two bound padding waste at <2x.
NODE_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096)
EDGE_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)


def pick_bucket(max_nodes: int, max_edges_per_graph: int) -> tuple[int, int]:
    """Smallest (N_max, E_max) bucket that fits the given per-graph sizes."""
    n_max = next((b for b in NODE_BUCKETS if b >= max_nodes), None)
    e_max = next((b for b in EDGE_BUCKETS if b >= max(1, max_edges_per_graph)), None)
    if n_max is None or e_max is None:
        raise ValueError(
            f"subgraph too large for bucket ladder: nodes={max_nodes}, "
            f"edges={max_edges_per_graph}"
        )
    return n_max, e_max


@dataclasses.dataclass(frozen=True)
class WireBatch:
    """Padded wire form: (B, E_max) int16 local edge endpoints (entries
    past each graph's n_edges are arbitrary) + (B,) int32 n_nodes,
    n_edges, seed_pos. The pipeline's start-up probe and its padded pairs
    (``compact_wire=False``) use it."""

    src: np.ndarray
    dst: np.ndarray
    n_nodes: np.ndarray
    n_edges: np.ndarray
    seed_pos: np.ndarray


@dataclasses.dataclass(frozen=True)
class CompactWireBatch:
    """Flat-edge wire form: per-graph edge runs concatenated into one
    packed (E_tot,) buffer instead of a padded (B, E_max) int16 grid.

      edges: (E_tot,) — uint16 ``src | dst << 8`` when the bucket's
        local ids fit a byte, else int32 ``src | dst << 16``. Stacked
        dispatch items carry (K, E_tot).
      meta:  (3, B) int32 — rows n_nodes, n_edges, seed_pos ((K, 3, B)
        when stacked).

    ``e_max`` is the per-graph edge cap, ``id_bits`` the packing width,
    and ``n_max`` the node bucket a routed item was sorted into (0 =
    unrouted: the consumer's bucket applies).
    """

    edges: np.ndarray
    meta: np.ndarray
    e_max: int = 2048
    id_bits: int = 8
    n_max: int = 0

    @property
    def src(self) -> np.ndarray:
        return (np.asarray(self.edges).astype(np.int32)
                & ((1 << self.id_bits) - 1))

    @property
    def dst(self) -> np.ndarray:
        return (np.asarray(self.edges).astype(np.int32) >> self.id_bits) & (
            (1 << self.id_bits) - 1
        )


def pack_edge_ids(src, dst, n_max: int):
    """Host-side packing of compact local edge ids into one integer per
    edge: uint16 (8+8 bits) when n_max <= 256, else int32 (16+16)."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    if n_max <= 256:
        return (src.astype(np.uint16) & 0xFF) | (
            (dst.astype(np.uint16) & 0xFF) << 8
        ), 8
    return (src.astype(np.int32) & 0xFFFF) | (
        (dst.astype(np.int32) & 0xFFFF) << 16
    ), 16


@dataclasses.dataclass(frozen=True)
class Subgraph:
    """Host-side subgraph: relabeled edge list + node count + seed position."""

    src: np.ndarray  # (E,) int32, local ids
    dst: np.ndarray  # (E,) int32, local ids
    num_nodes: int
    seed: int = 0  # local id of the walk seed (0 except entire-graph mode)


def _padded_from_locals(src_local, dst_local, valid, n_nodes, seed_pos,
                        n_max: int) -> PaddedSubgraphBatch:
    """Assemble a PaddedSubgraphBatch from (B, E_max) local edge ids."""
    b = n_nodes.shape[0]
    base = (np.arange(b, dtype=np.int32) * n_max)[:, None]
    node_iota = np.arange(n_max, dtype=np.int32)[None, :]
    node_mask = (node_iota < n_nodes[:, None]).astype(np.float32)
    seed_flag = (node_iota == seed_pos[:, None]).astype(np.float32)
    return PaddedSubgraphBatch(
        edges_src=(src_local + base).reshape(-1).astype(np.int32),
        edges_dst=(dst_local + base).reshape(-1).astype(np.int32),
        edge_weight=valid.astype(np.float32).reshape(-1),
        node_mask=node_mask,
        seed_flag=seed_flag * node_mask,
        n_nodes=np.asarray(n_nodes, np.int32),
    )


def expand_wire(wire: WireBatch, n_max: int) -> PaddedSubgraphBatch:
    """Expansion of a padded WireBatch ((B, E_max) local endpoints) into
    a PaddedSubgraphBatch (``gcc_tpu/graph/batch.py:221-233``): slots
    past each graph's n_edges become weight-0 loops on its node 0."""
    e_max = wire.src.shape[1]
    n_edges = np.asarray(wire.n_edges)
    valid = np.arange(e_max, dtype=np.int32)[None, :] < n_edges[:, None]
    src_local = np.where(valid, np.asarray(wire.src).astype(np.int32), 0)
    dst_local = np.where(valid, np.asarray(wire.dst).astype(np.int32), 0)
    return _padded_from_locals(src_local, dst_local, valid,
                               np.asarray(wire.n_nodes),
                               np.asarray(wire.seed_pos), n_max)


def concat_padded(b1: PaddedSubgraphBatch,
                  b2: PaddedSubgraphBatch) -> PaddedSubgraphBatch:
    """Stack two same-bucket padded batches into one (2B, ...) batch
    (``gcc_tpu/graph/batch.py:310-346``), so the query and key views
    featurize in one call."""
    off = b1.batch_size * b1.n_max
    return PaddedSubgraphBatch(
        edges_src=np.concatenate([b1.edges_src, b2.edges_src + off]),
        edges_dst=np.concatenate([b1.edges_dst, b2.edges_dst + off]),
        edge_weight=np.concatenate([b1.edge_weight, b2.edge_weight]),
        node_mask=np.concatenate([b1.node_mask, b2.node_mask]),
        seed_flag=np.concatenate([b1.seed_flag, b2.seed_flag]),
        n_nodes=np.concatenate([b1.n_nodes, b2.n_nodes]),
    )


def expand_compact(wire: CompactWireBatch, n_max: int) -> PaddedSubgraphBatch:
    """Expansion of an unstacked CompactWireBatch into the padded
    (B, E_max) layout (``gcc_tpu/graph/batch.py:236-278``): graph j owns
    slots [cum_j - n_j, cum_j) of the packed buffer, and slots past the
    edge total are dropped."""
    meta = np.asarray(wire.meta)
    edges = np.asarray(wire.edges).astype(np.int32)
    b = meta.shape[1]
    e_tot, e_max = edges.shape[0], wire.e_max
    n_nodes, n_edges, seed_pos = meta[0], meta[1], meta[2]
    cum = np.cumsum(n_edges)
    e_iota = np.arange(e_tot, dtype=np.int64)
    gid = np.minimum(np.searchsorted(cum, e_iota, side="right"), b - 1)
    pos = e_iota - (cum - n_edges)[gid]
    live = e_iota < cum[b - 1]
    padded = np.zeros(b * e_max, np.int32)
    padded[(gid * e_max + pos)[live]] = edges[live]
    padded = padded.reshape(b, e_max)
    mask_bits = (1 << wire.id_bits) - 1
    valid = np.arange(e_max, dtype=np.int32)[None, :] < n_edges[:, None]
    return _padded_from_locals(padded & mask_bits,
                               (padded >> wire.id_bits) & mask_bits, valid,
                               n_nodes, seed_pos, n_max)


def batch_subgraphs(
    graphs: Sequence[Subgraph],
    n_max: int | None = None,
    e_max: int | None = None,
) -> PaddedSubgraphBatch:
    """Pack host subgraphs into one padded batch (numpy; uploaded by the
    caller). Padding edges are self-loops on each graph's node 0 with
    weight 0, so they never contribute to aggregation and always index
    valid memory (``gcc_tpu/graph/batch.py:359-407``)."""
    bsz = len(graphs)
    if n_max is None or e_max is None:
        auto_n, auto_e = pick_bucket(
            max(g.num_nodes for g in graphs), max(len(g.src) for g in graphs)
        )
        n_max = n_max or auto_n
        e_max = e_max or auto_e

    edges_src = np.zeros((bsz, e_max), dtype=np.int32)
    edges_dst = np.zeros((bsz, e_max), dtype=np.int32)
    edge_weight = np.zeros((bsz, e_max), dtype=np.float32)
    node_mask = np.zeros((bsz, n_max), dtype=np.float32)
    seed_flag = np.zeros((bsz, n_max), dtype=np.float32)
    n_nodes = np.zeros((bsz,), dtype=np.int32)

    for b, g in enumerate(graphs):
        n, e = g.num_nodes, len(g.src)
        if n > n_max or e > e_max:
            raise ValueError(f"subgraph {b} ({n} nodes / {e} edges) exceeds bucket "
                             f"({n_max}, {e_max})")
        base = b * n_max
        edges_src[b, :e] = g.src + base
        edges_dst[b, :e] = g.dst + base
        edges_src[b, e:] = base
        edges_dst[b, e:] = base
        edge_weight[b, :e] = 1.0
        node_mask[b, :n] = 1.0
        seed_flag[b, g.seed] = 1.0
        n_nodes[b] = n

    return PaddedSubgraphBatch(
        edges_src=edges_src.reshape(-1),
        edges_dst=edges_dst.reshape(-1),
        edge_weight=edge_weight.reshape(-1),
        node_mask=node_mask,
        seed_flag=seed_flag,
        n_nodes=n_nodes,
    )
