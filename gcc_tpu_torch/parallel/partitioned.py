"""Edge-partitioned aggregation of one giant graph, the partition axis in
one process.

Counterpart of ``gcc_tpu/parallel/partitioned.py``. There the node
features are sharded over the "part" axis of a device mesh and every
device owns a static-shape slice of the edge list; here the D shards are
a leading dimension of the partition arrays and every aggregation runs
on the one device that holds ``h`` (D = 1 on a single card; any D gives
the same result). Each schedule computes

    out[v] = Σ_{(u→v)} w · h[u]

- :class:`PartitionedGraph` (round-robin edge shards): per-shard
  segment sums (gather + ``index_add_``) into full-size partials, summed
  over D — the reference's all_gather + segment-sum + psum_scatter.
- :class:`DensePartitionedGraph` (row blocks of the dense adjacency):
  one (D, rows_per, N) @ (N, F) product, reshaped to (N, F) — the
  reference's shard-local dense block.
- :class:`RingPartitionedGraph` (edges on their destination's shard,
  bucketed by the source's shard): per (shard, owner) bucket segment
  sums into each shard's own rows, in the hop order of the reference's
  ring of ``ppermute`` hops.

The host builders are numpy and produce the reference's arrays bit for
bit. The aggregations take a partition whose arrays are numpy or torch
(:func:`place_partition` moves them to a device once, so repeated
aggregations upload nothing). The segment schedule sums with
``index_add_``, whose CUDA atomics add in no fixed order; the ring
schedule (the giant path's for sparse graphs) with segment sums in a
fixed order; the dense schedule is one matrix product (full f32: the
port sets no TF32 switch).

Edges are padded to equal per-shard (or per-bucket) counts with
zero-weight 0→0 loops, keeping every shard shape static.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class PartitionedGraph(NamedTuple):
    """Static-shape edge partition of one giant graph.

    src/dst: (D, E_per) int32 global node ids (padded with 0→0 loops).
    weight: (D, E_per) float32, 0.0 on padding.
    num_nodes: padded node count (multiple of D).
    """

    src: np.ndarray
    dst: np.ndarray
    weight: np.ndarray
    num_nodes: int


def partition_edges(src: np.ndarray, dst: np.ndarray, num_nodes: int,
                    num_devices: int,
                    weight: np.ndarray | None = None) -> PartitionedGraph:
    """Round-robin edges into `num_devices` equal static shards
    (``partitioned.py:62-86``); an optional per-edge `weight` rides
    along, padding stays 0."""
    e = len(src)
    per = -(-e // num_devices)
    n_pad = -(-num_nodes // num_devices) * num_devices
    win = (np.ones(e, np.float32) if weight is None
           else np.asarray(weight, np.float32))
    s = np.zeros((num_devices, per), np.int32)
    d = np.zeros((num_devices, per), np.int32)
    w = np.zeros((num_devices, per), np.float32)
    for dev in range(num_devices):
        sl = slice(dev, e, num_devices)
        cnt = len(range(dev, e, num_devices))
        s[dev, :cnt] = src[sl]
        d[dev, :cnt] = dst[sl]
        w[dev, :cnt] = win[sl]
    return PartitionedGraph(src=s, dst=d, weight=w, num_nodes=n_pad)


def _tensor(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(dtype)


def partitioned_aggregate(pg: PartitionedGraph,
                          h: torch.Tensor) -> torch.Tensor:
    """out[v] = Σ_{(u→v)} w · h[u] for h (num_nodes, F): each shard's
    segment sum into a full-size partial, the D partials summed."""
    d_cnt, n = pg.src.shape[0], pg.num_nodes
    src = _tensor(pg.src, h.device, torch.int64)
    dst = _tensor(pg.dst, h.device, torch.int64)
    w = _tensor(pg.weight, h.device, h.dtype)
    # Shard d's partial lives at rows [d·N, (d+1)·N) of one buffer.
    shard = torch.arange(d_cnt, device=h.device)[:, None] * n
    partial = torch.zeros(d_cnt * n, h.shape[1], dtype=h.dtype,
                          device=h.device)
    partial.index_add_(0, (dst + shard).reshape(-1),
                       h[src.reshape(-1)] * w.reshape(-1, 1))
    return partial.view(d_cnt, n, -1).sum(0)


def partitioned_aggregate_batched(pg: PartitionedGraph,
                                  h: torch.Tensor) -> torch.Tensor:
    """The same for a batch of feature views of one graph: h (B, N, F),
    out[b, v] = Σ_{(u→v)} w · h[b, u] (``partitioned.py:117-163``; the
    reference spreads the batch over its mesh's "data" axis)."""
    d_cnt, n = pg.src.shape[0], pg.num_nodes
    src = _tensor(pg.src, h.device, torch.int64)
    dst = _tensor(pg.dst, h.device, torch.int64)
    w = _tensor(pg.weight, h.device, h.dtype)
    shard = torch.arange(d_cnt, device=h.device)[:, None] * n
    partial = torch.zeros(h.shape[0], d_cnt * n, h.shape[2], dtype=h.dtype,
                          device=h.device)
    partial.index_add_(1, (dst + shard).reshape(-1),
                       h[:, src.reshape(-1)] * w.reshape(1, -1, 1))
    return partial.view(h.shape[0], d_cnt, n, -1).sum(1)


def giant_graph_embedding_oracle(pg: PartitionedGraph,
                                 h: np.ndarray) -> np.ndarray:
    """Single-host numpy oracle for tests."""
    out = np.zeros_like(h)
    for dev in range(pg.src.shape[0]):
        np.add.at(out, pg.dst[dev],
                  h[pg.src[dev]] * pg.weight[dev][:, None])
    return out


class DensePartitionedGraph(NamedTuple):
    """Row-block DENSE partition of one giant graph's adjacency.

    adj: (D, rows_per, N) float32 — adj[d, v_local, u] = Σ w(u→v): shard
    d holds the adjacency rows of the output rows it owns, so one
    aggregation is one dense product and no reduction across shards.
    num_nodes: padded node count (multiple of D).
    """

    adj: np.ndarray
    num_nodes: int


def partition_dense(src: np.ndarray, dst: np.ndarray, num_nodes: int,
                    num_devices: int,
                    weight: np.ndarray | None = None
                    ) -> DensePartitionedGraph:
    """Build the row-block dense partition (multi-edges accumulate) in
    host memory, as ``partitioned.py:187-207`` does: N²·4 bytes, 256 MB
    at N = 8k."""
    d_cnt = num_devices
    n_pad = -(-num_nodes // d_cnt) * d_cnt
    rows_per = n_pad // d_cnt
    w = (np.ones(len(src), np.float32) if weight is None
         else np.asarray(weight, np.float32))
    adj = np.zeros((d_cnt, rows_per, n_pad), np.float32)
    dst = np.asarray(dst, np.int64)
    np.add.at(adj, (dst // rows_per, dst % rows_per, np.asarray(src)), w)
    return DensePartitionedGraph(adj=adj, num_nodes=n_pad)


def shard_dense_partition(pg: DensePartitionedGraph, parts: int,
                          device="cuda") -> DensePartitionedGraph:
    """Place pg.adj on `device` (``partitioned.py:210-229``, where each
    block goes to its own device). `parts` is the partition count the
    caller runs; a partition built for another count raises."""
    if pg.adj.shape[0] != parts:
        raise ValueError(
            f"dense partition built for {pg.adj.shape[0]} shards but the "
            f"partition count is {parts} — rebuild with "
            f"partition_dense(..., num_devices={parts})")
    return place_partition(pg, device)


def partitioned_aggregate_dense(pg: DensePartitionedGraph,
                                h: torch.Tensor) -> torch.Tensor:
    """out[v] = Σ_{(u→v)} w · h[u] as one (D, rows_per, N) @ (N, F)
    product. h must have the partition's N rows (``partitioned.py:
    233-239`` refuses a partition built for another device count, whose
    blocks would not cover the features)."""
    d_cnt, rows_per, n = pg.adj.shape
    if d_cnt * rows_per != n or h.shape[0] != n:
        raise ValueError(
            f"dense partition of {d_cnt} blocks of {rows_per} rows over "
            f"{n} nodes does not cover features of {h.shape[0]} rows")
    adj = _tensor(pg.adj, h.device, h.dtype)
    return torch.matmul(adj, h).reshape(n, h.shape[1])


class RingPartitionedGraph(NamedTuple):
    """Owner-bucketed edge partition for the ring schedule.

    src_local:  (D, D, E_b) int32 — src id local to its owner's block;
                [d, o] holds the edges destined to shard d whose source
                lives on shard o.
    dst_local:  (D, D, E_b) int32 — dst id local to shard d.
    weight:     (D, D, E_b) float32, 0.0 on padding.
    num_nodes:  padded node count (multiple of D).
    """

    src_local: np.ndarray
    dst_local: np.ndarray
    weight: np.ndarray
    num_nodes: int


def partition_edges_ring(src: np.ndarray, dst: np.ndarray, num_nodes: int,
                         num_devices: int,
                         weight: np.ndarray | None = None
                         ) -> RingPartitionedGraph:
    """Bucket edges by (dst owner, src owner) with contiguous row shards
    (``partitioned.py:272-311``). Row o of the feature matrix belongs to
    shard ``o // rows_per``; each (d, o) bucket is zero-padded to the
    largest bucket size (padding edges are 0→0 with weight 0)."""
    d_cnt = num_devices
    n_pad = -(-num_nodes // d_cnt) * d_cnt
    rows_per = n_pad // d_cnt
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    w = (np.ones(len(src), np.float32) if weight is None
         else np.asarray(weight, np.float32))
    d_owner = dst // rows_per
    s_owner = src // rows_per
    buckets = [[None] * d_cnt for _ in range(d_cnt)]
    e_b = 1
    for dd in range(d_cnt):
        on_d = d_owner == dd
        for oo in range(d_cnt):
            sel = on_d & (s_owner == oo)
            buckets[dd][oo] = sel
            e_b = max(e_b, int(sel.sum()))
    sl = np.zeros((d_cnt, d_cnt, e_b), np.int32)
    dl = np.zeros((d_cnt, d_cnt, e_b), np.int32)
    wb = np.zeros((d_cnt, d_cnt, e_b), np.float32)
    for dd in range(d_cnt):
        for oo in range(d_cnt):
            sel = buckets[dd][oo]
            cnt = int(sel.sum())
            sl[dd, oo, :cnt] = (src[sel] - oo * rows_per).astype(np.int32)
            dl[dd, oo, :cnt] = (dst[sel] - dd * rows_per).astype(np.int32)
            wb[dd, oo, :cnt] = w[sel]
    return RingPartitionedGraph(src_local=sl, dst_local=dl, weight=wb,
                                num_nodes=n_pad)


def partitioned_aggregate_ring(pg: RingPartitionedGraph,
                               h: torch.Tensor) -> torch.Tensor:
    """out[v] = Σ_{(u→v)} w · h[u]: every (shard d, owner o) bucket's
    messages, gathered from owner o's rows, summed into shard d's rows,
    the owners in the reference's ring-hop order (o = d, d - 1, ...); the
    shards' rows are the row-sharded result (no reduction across
    shards). Each bucket is summed by ``torch.segment_reduce`` over its
    edges sorted by destination (:func:`place_partition` sorts them), a
    fixed order on every device: unlike ``index_add_``'s atomics on CUDA,
    the card gives the same bits on every run."""
    if not torch.is_tensor(pg.src_local):
        pg = place_partition(pg, h.device)
    d_cnt = pg.src_local.shape[0]
    rows_per = pg.num_nodes // d_cnt
    w = pg.weight.to(h.dtype)
    row_ids = torch.arange(rows_per + 1, device=h.device)
    shards = []
    for d in range(d_cnt):
        acc = None
        for t in range(d_cnt):
            o = (d - t) % d_cnt
            msgs = h[o * rows_per:(o + 1) * rows_per].index_select(
                0, pg.src_local[d, o]).mul_(w[d, o, :, None])
            part = torch.segment_reduce(
                msgs, "sum", offsets=torch.searchsorted(pg.dst_local[d, o],
                                                        row_ids),
                axis=0, unsafe=True)
            acc = part if acc is None else acc + part
        shards.append(acc)
    return shards[0] if d_cnt == 1 else torch.cat(shards)


def place_partition(pg, device="cuda"):
    """A host partition with its arrays as tensors on `device` (ids
    int64, weights and adjacency float32), so that repeated aggregations
    upload nothing. A ring partition also drops the tail of its bucket
    width that is padding in every bucket (0→0 edges of weight 0, which
    add exact zeros to row 0 of their shard), and its buckets are sorted
    by destination (stable), as its aggregation sums them."""
    device = torch.device(device)
    ring = isinstance(pg, RingPartitionedGraph)
    if ring:
        pad = ((pg.src_local == 0) & (pg.dst_local == 0)
               & (pg.weight == 0)).all(axis=(0, 1))
        live = np.flatnonzero(~pad)
        e_keep = int(live[-1]) + 1 if live.size else 1
        pg = pg._replace(src_local=pg.src_local[..., :e_keep],
                         dst_local=pg.dst_local[..., :e_keep],
                         weight=pg.weight[..., :e_keep])
    placed = pg._replace(**{
        f: _tensor(getattr(pg, f), device,
                   torch.float32 if f in ("weight", "adj") else torch.int64)
        for f in pg._fields if f != "num_nodes"})
    if ring:
        # Sorted on the device: a stable sort keeps each destination's
        # edges in their host order.
        order = torch.sort(placed.dst_local, dim=-1, stable=True).indices
        placed = placed._replace(**{
            f: torch.gather(getattr(placed, f), -1, order)
            for f in ("src_local", "dst_local", "weight")})
    return placed
