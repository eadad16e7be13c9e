"""Streaming pretrain input pipeline (replaces torch DataLoader, N16).

The reference parallelizes sampling with DataLoader worker processes,
each owning a size-balanced partition of the corpus graphs
(graph_dataset.py:23-92). Here the same scheme runs as background
sampler threads (the default: the native sampler releases the GIL) or
forked worker processes (``mode="process"``) that push ready-to-ship
wire batches over a queue, so host sampling overlaps device compute. A
synchronous in-process mode (``num_workers=0``) serves tests and
low-CPU hosts.

Forked workers start from a parent that may already hold a CUDA
context. They touch no ``torch.cuda`` API: they run the numpy and
native sampler and put numpy items on the queue (a CUDA call in a forked
child would raise, and the consumer re-raises a worker's error).

Static-shape policy: every batch is packed into one configured
(n_max, e_max) bucket. Subgraphs whose RWR budget would exceed the
bucket are truncated at the bucket size by the native sampler
(node_cap/e_cap) — a bounded deviation from the reference, which has no
cap; with rw_hops=256 and n_max=256 only seeds of very high degree are
affected.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import queue as queue_mod
from typing import Iterator

import numpy as np

from gcc_tpu_torch.config import SamplerConfig
from gcc_tpu_torch.graph.batch import CompactWireBatch, WireBatch, pack_edge_ids
from gcc_tpu_torch.graph.corpus import CorpusStore, partition_graphs
from gcc_tpu_torch.sampling import native
from gcc_tpu_torch.sampling.sampler import (
    degree_weights,
    rwr_budgets,
    sample_contrastive_pairs_raw,
)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    batch_size: int = 32
    n_max: int = 512
    e_max: int = 8192
    num_samples: int = 2000   # per worker per epoch (reference --num-samples)
    num_workers: int = 1      # 0 = synchronous in-process
    num_copies: int = 1
    prefetch: int = 32
    threads_per_worker: int = 1
    degree_power: float = 0.75
    # "thread": background prefetch threads (the default). "process":
    # forked worker processes, for hosts with cores to spare
    # (gcc_tpu/sampling/pipeline.py:50-56).
    mode: str = "thread"
    # Pairs sampled per native-sampler call: one big C++ call is sliced
    # into `super_batch` wire pairs, amortizing the Python call overhead.
    super_batch: int = 8
    # Ship batches as CompactWireBatch (flat packed edge buffer of
    # e_tot slots) instead of padded (B, E_max) int16 rows. e_tot=None →
    # auto-sized at startup: a probe super-batch over the whole corpus
    # sets e_tot to 1.5x the largest observed batch edge total (rounded
    # up to 512). Overflow truncates host-side with exact counts kept and
    # a warning.
    compact_wire: bool = True
    e_tot: int | None = None
    # "pairs": iterator yields one (query, key) wire pair per step.
    # "stacked": yields one stacked pair per super_batch — CompactWireBatch
    #   with (super_batch, e_tot) edges / (super_batch, 3, B) meta leaves,
    #   exactly the K-step dispatch layout (training/pretrain.py).
    #   Requires compact_wire + the native sampler + n_max <= 256.
    # "routed": like "stacked", plus size-bucket routing: pairs whose two
    #   subgraphs both fit `n_small` nodes are accumulated into items
    #   tagged n_max=n_small; the rest into n_max=`n_max` items. Batches
    #   are size-class-homogeneous and large pairs are DELAYED until a
    #   full item of them accumulates (order-only for the MoCo objective
    #   — negatives come from the queue, not the batch; BN batch
    #   statistics see size-sorted batches).
    emit: str = "pairs"
    n_small: int = 128
    # Per-class compact-wire budgets (None → probed at startup alongside
    # e_tot). The large class is rare, so its budget is sized generously
    # from per-pair maxima rather than observed batch sums.
    e_tot_small: int | None = None
    e_tot_large: int | None = None
    # Data-parallel device count (gcc_tpu/sampling/pipeline.py:108-120).
    # With devices=D > 1 (stacked/routed emit only), each item carries an
    # explicit device axis: edges (K, D, e_dev) / meta (K, D, 3, B/D) —
    # step k's graphs split into D consecutive groups of B/D, each
    # compacted into its own per-device edge segment, rows in (step,
    # device) order. A data-parallel rank keeps its slice of the D axis.
    # e_tot / e_tot_small / e_tot_large are then PER-DEVICE budgets and
    # the start-up probe sizes them from B/D-graph group sums. Sampling
    # content and order are identical to devices=1 — only the wire layout
    # changes — so a DP run is step-for-step comparable to one device.
    devices: int = 1


class _RouterPool:
    """Per-size-class accumulator of uint16-packed wire rows (emit="routed").

    Holds query and key sides in parallel (rows always appended for both),
    each as a flat packed-edge buffer + per-row (n, e) arrays + an int64
    {row_off, edge_off} cursor mutated by the native append
    (native.pack_rows16). flat is sized for full-e_cap rows so the append
    never truncates; truncation happens only at item assembly against the
    class e_tot (accounted like every compact-wire overflow).
    """

    def __init__(self, cap_rows: int, flat_cap: int):
        self.q = (np.empty(flat_cap, np.uint16),
                  np.empty(cap_rows, np.int32),
                  np.empty(cap_rows, np.int32),
                  np.zeros(2, np.int64))
        self.k = (np.empty(flat_cap, np.uint16),
                  np.empty(cap_rows, np.int32),
                  np.empty(cap_rows, np.int32),
                  np.zeros(2, np.int64))

    @property
    def rows(self) -> int:
        return int(self.q[3][0])

    def pop_side(self, side, rows_use: int, b: int, k_steps: int,
                 e_tot: int):
        """Assemble (k_steps, e_tot) edges + (k_steps, 3, b) meta from the
        first rows_use rows of one side, then compact the remainder to the
        buffer front. Returns (edges, meta, dropped_edges)."""
        flat, pn, pe, st = side
        e = pe[:rows_use].reshape(k_steps, b)
        n = pn[:rows_use].reshape(k_steps, b)
        tot = e.sum(axis=1, dtype=np.int64)
        starts = np.concatenate([[0], np.cumsum(tot)[:-1]])
        edges = np.zeros((k_steps, e_tot), np.uint16)
        meta = np.zeros((k_steps, 3, b), np.int32)
        meta[:, 0] = n
        dropped = 0
        if (tot <= e_tot).all():
            meta[:, 1] = e
            for s in range(k_steps):
                edges[s, : tot[s]] = flat[starts[s] : starts[s] + tot[s]]
        else:
            # Rare overflow: clip trailing rows of the offending steps
            # (counts stay exact — same contract as gcc_compact_pack16).
            for s in range(k_steps):
                kept = np.minimum(
                    e[s], np.maximum(0, e_tot - (np.cumsum(e[s]) - e[s]))
                ).astype(np.int32)
                meta[s, 1] = kept
                off, o = int(starts[s]), 0
                for j in range(b):
                    t = int(kept[j])
                    edges[s, o : o + t] = flat[off : off + t]
                    o += t
                    off += int(e[s, j])
                dropped += int(tot[s]) - int(kept.sum())
        consumed = int(np.sum(pe[:rows_use], dtype=np.int64))
        rem_rows = int(st[0]) - rows_use
        rem_edges = int(st[1]) - consumed
        pn[:rem_rows] = pn[rows_use : rows_use + rem_rows].copy()
        pe[:rem_rows] = pe[rows_use : rows_use + rem_rows].copy()
        flat[:rem_edges] = flat[consumed : consumed + rem_edges].copy()
        st[0], st[1] = rem_rows, rem_edges
        return edges, meta, dropped


class ShardSampler:
    """Sampling logic for one worker's corpus shard (one or more graphs)."""

    def __init__(self, store: CorpusStore, graph_ids: list[int],
                 cfg: SamplerConfig, pcfg: PipelineConfig, seed: int):
        self.graphs = [store.load(i) for i in graph_ids]
        self.cfg = cfg
        self.pcfg = pcfg
        self.rng_seed = seed
        # deg^0.75 seed sampling over the shard (graph_dataset.py:86-92).
        self.weights = degree_weights(self.graphs, pcfg.degree_power)
        self.offsets = np.cumsum(
            [0] + [g.num_nodes for g in self.graphs]
        )
        self._cdf = np.ascontiguousarray(np.cumsum(self.weights))
        self._sample_counter = 0
        self._ready: list = []
        self._wire_buf = None    # reused (bsz, e_max) super-batch buffers
        self._native_buf = None  # reused native-call output buffers
        self.dropped_edges = 0       # compact-wire overflow accounting
        self.truncated_batches = 0
        self._pools: dict | None = None   # emit="routed" class pools

    def next_pair(self) -> tuple[WireBatch, WireBatch]:
        # "while": a routed super-batch may emit nothing until a class
        # pool fills.
        while not self._ready:
            self._ready = list(self._sample_super_batch())
        return self._ready.pop(0)

    def _sample_super_batch(self):
        """Sample `super_batch` (query, key) pairs in one fused native
        call that writes int16 wire buffers directly — the GIL stays
        released for the whole sampling+packing stage, and the Python
        cost per pair is a couple of array slices."""
        bsz = self.pcfg.batch_size * max(1, self.pcfg.super_batch)
        e_max = self.pcfg.e_max
        base = self._sample_counter
        self._sample_counter += bsz
        flat = native.weighted_sample(
            self.weights, bsz,
            rng_seed=hash((self.rng_seed, base)) & (2**63 - 1),
            cdf=self._cdf,
        )
        # flat node id -> (graph, node)
        gidx = np.searchsorted(self.offsets, flat, side="right") - 1
        nidx = flat - self.offsets[gidx]

        # Reused across super-batches. Row tails past n_edges hold stale
        # bytes, which every consumer masks or skips (compaction).
        if self._wire_buf is None:
            self._wire_buf = tuple(
                np.empty((bsz, e_max), np.int16) for _ in range(4)
            ) + (np.empty((4, bsz), np.int32),)
        q_src, q_dst, k_src, k_dst, counts = self._wire_buf
        if self._native_buf is None and native.native_available():
            self._native_buf = tuple(
                np.empty((bsz, e_max), np.int16) if j % 4 < 2
                else np.empty(bsz, np.int32)
                for j in range(8)
            )

        # The fused path assumes key seed == query seed (step_dist[0]==1,
        # the default); the generic path handles step_dist walks.
        use_fused = (native.native_available()
                     and self.cfg.step_dist[0] == 1.0)
        # Routed + fused: append each graph-group's rows to the class
        # pools straight from the native output buffers.
        route_direct = self.pcfg.emit == "routed" and use_fused
        if route_direct:
            self._ensure_pools(bsz, e_max)
        for g_id in np.unique(gidx):
            mask = gidx == g_id
            rows = np.where(mask)[0]
            graph = self.graphs[int(g_id)]
            seeds = nidx[mask]
            ids = base + rows
            if use_fused:
                budgets = rwr_budgets(graph, seeds, self.cfg,
                                      degree_power=True)
                s = len(rows)
                out = native.sample_wire_pairs(
                    graph, seeds, seeds, budgets, budgets,
                    self.cfg.restart_prob, self.cfg.aug,
                    self.cfg.num_neighbors, self.cfg.rw_hops,
                    self.rng_seed, ids, self.pcfg.n_max, e_max,
                    n_threads=self.pcfg.threads_per_worker,
                    out=tuple(b[:s] for b in self._native_buf),
                )
                if route_direct:
                    self._route_append(out)
                    continue
                q_src[rows], q_dst[rows] = out[0], out[1]
                counts[0][rows], counts[1][rows] = out[2], out[3]
                k_src[rows], k_dst[rows] = out[4], out[5]
                counts[2][rows], counts[3][rows] = out[6], out[7]
            else:
                out_q, out_k = sample_contrastive_pairs_raw(
                    graph, seeds, self.cfg, rng_seed=self.rng_seed,
                    sample_ids=ids,
                    n_threads=self.pcfg.threads_per_worker,
                    node_cap=self.pcfg.n_max, e_cap=e_max,
                )
                q_src[rows] = out_q.src
                q_dst[rows] = out_q.dst
                counts[0][rows], counts[1][rows] = out_q.n, out_q.e
                k_src[rows] = out_k.src
                k_dst[rows] = out_k.dst
                counts[2][rows], counts[3][rows] = out_k.n, out_k.e

        if self.pcfg.emit == "routed":
            if not route_direct:
                self._ensure_pools(bsz, e_max)
                self._route_append((q_src, q_dst, counts[0], counts[1],
                                    k_src, k_dst, counts[2], counts[3]))
            return self._route_emit(e_max)

        pairs = []
        step = self.pcfg.batch_size
        compact = self.pcfg.compact_wire
        e_tot = self.pcfg.e_tot or (
            step // max(1, self.pcfg.devices) * e_max // 4)
        if (compact and self.pcfg.n_max <= 256
                and native.native_available()):
            # Fused native compaction + uint16 packing for the whole
            # super-batch (one call instead of a python loop per batch).
            n_b = bsz // step
            dev = max(1, self.pcfg.devices)
            # devices > 1: per-device groups of step/dev graphs, each in
            # its own e_tot (per-device budget) segment; rows are in
            # (step, device) order, so the reshape below is a view.
            qe, qm, qd = native.compact_pack16(
                q_src, q_dst, counts[0], counts[1], n_b * dev, step // dev,
                e_tot)
            ke, km, kd = native.compact_pack16(
                k_src, k_dst, counts[2], counts[3], n_b * dev, step // dev,
                e_tot)
            self._account_drops(int(qd.sum() + kd.sum()),
                                int((qd > 0).sum() + (kd > 0).sum()), e_tot)
            if self.pcfg.emit == "stacked":
                if dev > 1:
                    qe, qm = _device_axis(qe, qm, n_b, dev)
                    ke, km = _device_axis(ke, km, n_b, dev)
                # One stacked item per super-batch: the native buffers
                # are already (n_b, e_tot)/(n_b, 3, step) — ship them
                # whole, no per-step slicing or consumer re-stack.
                return [(
                    CompactWireBatch(edges=qe, meta=qm, e_max=e_max,
                                     id_bits=8),
                    CompactWireBatch(edges=ke, meta=km, e_max=e_max,
                                     id_bits=8),
                )]
            return [
                (CompactWireBatch(edges=qe[b], meta=qm[b], e_max=e_max,
                                  id_bits=8),
                 CompactWireBatch(edges=ke[b], meta=km[b], e_max=e_max,
                                  id_bits=8))
                for b in range(n_b)
            ]
        for lo in range(0, bsz, step):
            hi = lo + step
            if compact:
                pairs.append((
                    self._compact(q_src[lo:hi], q_dst[lo:hi],
                                  counts[0, lo:hi], counts[1, lo:hi],
                                  e_tot, e_max),
                    self._compact(k_src[lo:hi], k_dst[lo:hi],
                                  counts[2, lo:hi], counts[3, lo:hi],
                                  e_tot, e_max),
                ))
            else:
                # .copy(): the underlying buffers are reused by the next
                # super-batch while these batches sit in the prefetch queue.
                pairs.append((
                    WireBatch(src=q_src[lo:hi].copy(), dst=q_dst[lo:hi].copy(),
                              n_nodes=counts[0, lo:hi].copy(),
                              n_edges=counts[1, lo:hi].copy(),
                              seed_pos=np.zeros(step, np.int32)),
                    WireBatch(src=k_src[lo:hi].copy(), dst=k_dst[lo:hi].copy(),
                              n_nodes=counts[2, lo:hi].copy(),
                              n_edges=counts[3, lo:hi].copy(),
                              seed_pos=np.zeros(step, np.int32)),
                ))
        return pairs

    def _ensure_pools(self, bsz: int, e_max: int):
        if self._pools is not None:
            return
        # Capacity: after the emit loop a pool holds < need rows, and
        # one super-batch appends at most bsz more. flat is sized for
        # full-e_cap rows so the native append never truncates.
        need = self.pcfg.batch_size * max(1, self.pcfg.super_batch)
        cap_rows = need + bsz
        self._pools = {
            "small": _RouterPool(cap_rows, cap_rows * e_max),
            "large": _RouterPool(cap_rows, cap_rows * e_max),
        }

    def _route_append(self, bufs):
        """Append sampled rows to their class pools (emit="routed").

        bufs: (q_src, q_dst, q_n, q_e, k_src, k_dst, k_n, k_e) — either
        one graph-group's native output slices (fused path, zero copies)
        or the whole super-batch wire buffers (generic fallback)."""
        q_src, q_dst, qn, qe, k_src, k_dst, kn, ke = bufs
        small = (np.asarray(qn) <= self.pcfg.n_small) & (
            np.asarray(kn) <= self.pcfg.n_small
        )
        for name, rows in (("small", np.where(small)[0]),
                           ("large", np.where(~small)[0])):
            if not rows.size:
                continue
            pool = self._pools[name]
            rows = rows.astype(np.int32)
            native.pack_rows16(q_src, q_dst, qn, qe, rows, *pool.q)
            native.pack_rows16(k_src, k_dst, kn, ke, rows, *pool.k)

    def _route_emit(self, e_max: int):
        """Emit one stacked item per class pool holding a full
        super-batch. See PipelineConfig.emit for semantics."""
        pcfg = self.pcfg
        step, k_steps = pcfg.batch_size, max(1, pcfg.super_batch)
        dev = max(1, pcfg.devices)
        need = step * k_steps
        items = []
        for name, n_tag, e_tot in (
            ("small", pcfg.n_small, pcfg.e_tot_small),
            ("large", pcfg.n_max, pcfg.e_tot_large),
        ):
            pool = self._pools[name]
            e_tot = e_tot or (step // dev * e_max // 4)
            while pool.rows >= need:
                # devices > 1: k_steps * dev groups of step / dev graphs.
                qe, qm, qd = pool.pop_side(pool.q, need, step // dev,
                                           k_steps * dev, e_tot)
                ke, km, kd = pool.pop_side(pool.k, need, step // dev,
                                           k_steps * dev, e_tot)
                self._account_drops(qd + kd, 1 if (qd or kd) else 0, e_tot)
                if dev > 1:
                    qe, qm = _device_axis(qe, qm, k_steps, dev)
                    ke, km = _device_axis(ke, km, k_steps, dev)
                items.append((
                    CompactWireBatch(edges=qe, meta=qm, e_max=e_max,
                                     id_bits=8, n_max=n_tag),
                    CompactWireBatch(edges=ke, meta=km, e_max=e_max,
                                     id_bits=8, n_max=n_tag),
                ))
        return items

    def _account_drops(self, dropped: int, batches: int, e_tot: int):
        """Surface compact-wire overflow: trailing graphs lost edges
        (counts in n_edges stay exact, so training sees fewer edges,
        never corrupt ones). A corpus whose edge distribution exceeds
        the e_tot sizing should raise PipelineConfig.e_tot."""
        if dropped <= 0:
            return
        first = self.truncated_batches == 0
        self.dropped_edges += dropped
        self.truncated_batches += batches
        if first or self.truncated_batches in (100, 10_000):
            import sys

            print(
                f"gcc_tpu_torch sampler: compact-wire overflow — dropped "
                f"{dropped} edges (batch sum > e_tot={e_tot}); "
                f"{self.truncated_batches} batches affected so far. "
                f"Raise PipelineConfig.e_tot.", file=sys.stderr,
            )

    def _compact(self, src, dst, n, e, e_tot: int,
                 e_max: int) -> CompactWireBatch:
        c_src, c_dst, c_e, total = native.compact_rows(src, dst, e, e_tot)
        dropped = int(np.asarray(e, np.int64).sum()) - total
        self._account_drops(dropped, 1 if dropped > 0 else 0, e_tot)
        meta = np.stack([np.asarray(n, np.int32), c_e,
                         np.zeros(len(n), np.int32)])
        packed, id_bits = pack_edge_ids(c_src, c_dst, self.pcfg.n_max)
        return CompactWireBatch(
            edges=packed, meta=meta, e_max=e_max, id_bits=id_bits,
        )


def _device_axis(edges: np.ndarray, meta: np.ndarray, k_steps: int,
                 dev: int):
    """(K·D, e) edges / (K·D, 3, b) meta in (step, device) order →
    (K, D, e) / (K, D, 3, b): a view."""
    return (edges.reshape(k_steps, dev, edges.shape[-1]),
            meta.reshape(k_steps, dev, 3, meta.shape[-1]))


def _group_size(pcfg: PipelineConfig) -> int:
    """Graphs per compact-wire segment: the whole batch at devices=1,
    a per-device slice of it under data parallelism."""
    return pcfg.batch_size // max(1, pcfg.devices)


def _max_group_sum(stats, group: int) -> int:
    """Largest edge total over consecutive `group`-pair windows of the
    probe stats (compaction composes segments exactly that way)."""
    best = 0
    for _, qe, _, ke in stats:
        for arr in (qe, ke):
            m = arr.size // group * group
            if m:
                best = max(best,
                           int(arr[:m].reshape(-1, group).sum(axis=1).max()))
    return best


def _probe_pairs(store: CorpusStore, cfg: SamplerConfig,
                 pcfg: PipelineConfig, seed: int,
                 graph_ids: list[int] | None = None):
    """Draw one probe super-batch of plain wire pairs (own RNG stream)
    and return their per-pair stats [(q_n, q_e, k_n, k_e), ...]."""
    probe_cfg = dataclasses.replace(pcfg, compact_wire=False, emit="pairs")
    if graph_ids is None:
        graph_ids = list(range(len(store.graph_sizes)))
    shard = ShardSampler(store, list(graph_ids),
                         cfg, probe_cfg, seed + 104_729)
    out = []
    for _ in range(max(1, probe_cfg.super_batch)):
        q, k = shard.next_pair()
        out.append((np.asarray(q.n_nodes).copy(), np.asarray(q.n_edges).copy(),
                    np.asarray(k.n_nodes).copy(), np.asarray(k.n_edges).copy()))
    return out


def _round_e_tot(value: float, pcfg: PipelineConfig) -> int:
    hard_cap = _group_size(pcfg) * pcfg.e_max
    return int(np.clip(int(np.ceil(value / 512)) * 512, 1024, hard_cap))


def _probe_class_e_tots(stats, pcfg: PipelineConfig) -> tuple[int, int]:
    """Per-class compact budgets for emit="routed" from probe stats.

    Small class: 1.5x the max probe segment edge total over segments
    formed of consecutive small pairs (routing composes segments exactly
    that way; a segment is the batch at devices=1, a per-device slice
    under DP). Large class: rare — probes seldom yield a full segment of
    them, so size from per-pair maxima instead (b · 1.5 · max pair
    edges)."""
    qn = np.concatenate([s[0] for s in stats])
    qe = np.concatenate([s[1] for s in stats])
    kn = np.concatenate([s[2] for s in stats])
    ke = np.concatenate([s[3] for s in stats])
    small = (qn <= pcfg.n_small) & (kn <= pcfg.n_small)
    side_max = np.maximum(qe, ke)
    b = _group_size(pcfg)

    def class_budget(mask):
        vals = side_max[mask]
        if vals.size >= b:
            chunks = vals[: vals.size // b * b].reshape(-1, b).sum(axis=1)
            return _round_e_tot(float(chunks.max()) * 1.5, pcfg)
        per_pair = float(vals.max()) if vals.size else float(pcfg.e_max)
        return _round_e_tot(per_pair * b * 1.5, pcfg)

    return class_budget(small), class_budget(~small)


class _WorkerError:
    """Sentinel carrying a worker failure to the consumer."""

    def __init__(self, err: str):
        self.err = err


def _worker_main(store_path, graph_ids, cfg, pcfg, seed, out_q, stop_ev):
    try:
        store = CorpusStore.open(store_path)
        shard = ShardSampler(store, graph_ids, cfg, pcfg, seed)
        while not stop_ev.is_set():
            pair = shard.next_pair()
            while not stop_ev.is_set():
                try:
                    out_q.put(pair, timeout=0.5)
                    break
                except queue_mod.Full:
                    continue
    except Exception:  # surface crashes instead of hanging the trainer
        import traceback

        try:
            out_q.put(_WorkerError(traceback.format_exc()), timeout=5)
        except queue_mod.Full:
            pass


class PretrainPipeline:
    """Iterator of (query, key) wire batches over a corpus.

    num_workers=0 runs synchronously in-process; otherwise background
    threads or forked processes (``PipelineConfig.mode``) each own a
    greedy size-balanced shard of the corpus (num_copies replicates the
    assignment, reference graph_dataset.py:76), worker w sampling with
    seed + 7919·(w + 1). graph_ids restricts sampling to a subset of the
    corpus (None = all).
    """

    def __init__(self, store: CorpusStore, cfg: SamplerConfig,
                 pcfg: PipelineConfig, seed: int = 0,
                 graph_ids: list[int] | None = None):
        self.store = store
        self.cfg = cfg
        self.graph_ids = (list(graph_ids) if graph_ids is not None
                          else list(range(len(store.graph_sizes))))
        if not self.graph_ids:
            raise ValueError("graph_ids restriction is empty")
        if pcfg.mode not in ("thread", "process"):
            raise ValueError(f"unknown sampler mode: {pcfg.mode!r}")
        if pcfg.emit in ("stacked", "routed") and not (
            pcfg.compact_wire and pcfg.n_max <= 256
            and native.native_available()
        ):
            raise ValueError(
                f"emit={pcfg.emit!r} requires compact_wire, n_max <= 256 "
                "and the native sampler (the stacked buffers come from "
                "the native packing kernels)"
            )
        if pcfg.emit == "routed" and not pcfg.n_small < pcfg.n_max:
            raise ValueError("emit='routed' needs n_small < n_max")
        if pcfg.devices > 1 and (pcfg.emit not in ("stacked", "routed")
                                 or pcfg.batch_size % pcfg.devices):
            raise ValueError(
                f"devices={pcfg.devices} needs emit='stacked' or 'routed' "
                f"and a batch_size divisible by it, got emit="
                f"{pcfg.emit!r}, batch_size={pcfg.batch_size}")
        if pcfg.compact_wire and (
            pcfg.e_tot is None
            or (pcfg.emit == "routed"
                and (pcfg.e_tot_small is None or pcfg.e_tot_large is None))
        ):
            stats = _probe_pairs(store, cfg, pcfg, seed,
                                 graph_ids=self.graph_ids)
            # 1.5x the largest segment edge total seen (a segment is the
            # batch, or a device's slice of it under DP).
            max_total = _max_group_sum(stats, _group_size(pcfg))
            updates = {"e_tot": pcfg.e_tot
                       or _round_e_tot(max_total * 1.5, pcfg)}
            if pcfg.emit == "routed":
                e_small, e_large = _probe_class_e_tots(stats, pcfg)
                updates["e_tot_small"] = pcfg.e_tot_small or e_small
                updates["e_tot_large"] = pcfg.e_tot_large or e_large
            pcfg = dataclasses.replace(pcfg, **updates)
        self.pcfg = pcfg
        self.seed = seed
        self._workers: list = []
        self._queue = None
        self._stop = None
        if pcfg.num_workers > 0:
            self._start_workers()
        else:
            jobs = self._partition(1)
            self._shard = ShardSampler(store, jobs[0], cfg, pcfg, seed)

    def _partition(self, num_workers: int, num_copies: int = 1):
        """Greedy size-balanced worker partition WITHIN this pipeline's
        graph_ids restriction."""
        sizes = [self.store.graph_sizes[i] for i in self.graph_ids]
        jobs = partition_graphs(sizes, num_workers, num_copies)
        return [[self.graph_ids[j] for j in job] for job in jobs]

    def _start_workers(self):
        if self.pcfg.mode == "process":
            # The reference forks too (pipeline.py:699-711): the workers
            # inherit the corpus path and configs without pickling.
            ctx = mp.get_context("fork")
            self._queue = ctx.Queue(maxsize=self.pcfg.prefetch)
            self._stop = ctx.Event()
            spawn = ctx.Process
        else:
            import threading

            self._queue = queue_mod.Queue(maxsize=self.pcfg.prefetch)
            self._stop = threading.Event()
            spawn = threading.Thread
        jobs = self._partition(self.pcfg.num_workers, self.pcfg.num_copies)
        for w, graph_ids in enumerate(jobs):
            worker = spawn(
                target=_worker_main,
                args=(self.store.path, graph_ids, self.cfg, self.pcfg,
                      self.seed + 7919 * (w + 1), self._queue, self._stop),
                daemon=True,
            )
            worker.start()
            self._workers.append(worker)

    def __iter__(self) -> Iterator[tuple[CompactWireBatch, CompactWireBatch]]:
        return self

    def __next__(self):
        if self._queue is not None:
            while True:
                try:
                    item = self._queue.get(timeout=5)
                    break
                except queue_mod.Empty:
                    # A worker that died without a word (a forked one
                    # killed by a signal) would otherwise stall us forever.
                    if not any(w.is_alive() for w in self._workers):
                        raise RuntimeError(
                            "every sampler worker has exited") from None
            if isinstance(item, _WorkerError):
                raise RuntimeError(f"sampler worker crashed:\n{item.err}")
            return item
        return self._shard.next_pair()

    @property
    def steps_per_epoch(self) -> int:
        workers = max(1, self.pcfg.num_workers)
        return self.pcfg.num_samples * workers // self.pcfg.batch_size

    def close(self):
        if self._stop is not None:
            self._stop.set()
            # Drain so producers blocked on a full queue can observe stop.
            try:
                while True:
                    self._queue.get_nowait()
            except queue_mod.Empty:
                pass
            for w in self._workers:
                w.join(timeout=5)
                if isinstance(w, mp.process.BaseProcess) and w.is_alive():
                    # A child whose queue feeder still holds items past
                    # the drain cannot exit on its own.
                    w.terminate()
                    w.join(timeout=5)
            self._workers = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
