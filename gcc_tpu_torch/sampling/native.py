"""ctypes bindings for the native sampler, with a pure-numpy fallback.

The numpy fallback implements the identical behavior contract (same trace
semantics, same outputs) with numpy RNG; it exists so the framework runs
anywhere and so tests have an independent implementation to cross-check
structural properties against. Exact bit-parity between the two is not a
goal (they use different RNG streams by design).
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import numpy as np

from gcc_tpu_torch.graph.csr import CSRGraph
from gcc_tpu_torch.sampling.build import OUT as _LIB_PATH

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    # Always go through build(): it is mtime-cached (no-op when the .so
    # is current) and rebuilds a STALE library. Loading a pre-existing
    # .so built from older sources is silently wrong when the C ABI
    # grows (ctypes would drop trailing args the old code never reads —
    # e.g. the rows_sorted flags — and every feature behind them would
    # no-op with tests passing vacuously).
    try:
        from gcc_tpu_torch.sampling.build import build

        build()
    except Exception:
        if not os.path.exists(_LIB_PATH):
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

    lib.gcc_sample_subgraphs.argtypes = [
        i64p, i32p, ctypes.c_int64,          # indptr, indices, num_nodes
        i64p, ctypes.c_int64, i64p,          # seeds, num_seeds, budgets
        ctypes.c_double, ctypes.c_int32,     # restart_prob, aug
        ctypes.c_int64, ctypes.c_int64,      # expand, hops
        ctypes.c_uint64, i64p,               # rng_seed, sample_ids
        ctypes.c_int64, ctypes.c_int64,      # node_cap, e_cap
        ctypes.c_int32,                      # n_threads
        i32p, i32p, i32p, i32p, i32p, i64p,  # outputs
        ctypes.c_int32,                      # flags (bit 0: rows sorted)
    ]
    lib.gcc_random_walk.argtypes = [
        i64p, i32p, ctypes.c_int64, i64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_uint64, i64p, i64p,
    ]
    lib.gcc_weighted_sample.argtypes = [
        f64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64, i64p,
    ]
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    lib.gcc_compact_rows.argtypes = [
        i16p, i16p, i32p,                    # src, dst, e
        ctypes.c_int64, ctypes.c_int64,      # rows, e_cap
        ctypes.c_int64,                      # cap_total
        i16p, i16p, i32p, i64p,              # out_src, out_dst, e_out, total
    ]
    lib.gcc_sampler_stats.argtypes = [i64p, ctypes.c_int32]
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    lib.gcc_compact_pack16.argtypes = [
        i16p, i16p, i32p, i32p,              # src, dst, n, e
        ctypes.c_int64, ctypes.c_int64,      # n_batches, step
        ctypes.c_int64, ctypes.c_int64,      # e_cap, e_tot
        u16p, i32p, i64p,                    # out_edges, out_meta, dropped
    ]
    lib.gcc_pack_rows16.argtypes = [
        i16p, i16p, i32p, i32p,              # src, dst, n, e
        i32p, ctypes.c_int64,                # rows, n_rows
        ctypes.c_int64,                      # e_cap
        u16p, ctypes.c_int64,                # flat, flat_cap
        i32p, i32p, i64p,                    # pool_n, pool_e, st
    ]
    lib.gcc_sample_wire_pairs.argtypes = [
        i64p, i32p, ctypes.c_int64,          # csr
        i64p, i64p, ctypes.c_int64,          # seeds_q, seeds_k, num
        i64p, i64p,                          # budgets
        ctypes.c_double, ctypes.c_int32,     # restart, aug
        ctypes.c_int64, ctypes.c_int64,      # expand, hops
        ctypes.c_uint64, i64p,               # rng_seed, sample_ids
        ctypes.c_int64, ctypes.c_int64,      # node_cap, e_cap
        ctypes.c_int32,                      # threads
        i16p, i16p, i32p, i32p,              # q outputs
        i16p, i16p, i32p, i32p,              # k outputs
        ctypes.c_int32,                      # flags (bit 0: rows sorted)
    ]
    _lib = lib
    return lib


def sample_wire_pairs(
    g: CSRGraph,
    seeds_q: np.ndarray,
    seeds_k: np.ndarray,
    budgets_q: np.ndarray,
    budgets_k: np.ndarray,
    restart_prob: float,
    aug: str,
    expand: int,
    hops: int,
    rng_seed: int,
    sample_ids: np.ndarray,
    node_cap: int,
    e_cap: int,
    n_threads: int = 1,
    out=None,
):
    """Fused pair sampling straight into int16 wire buffers (GIL released
    for the whole call). Returns 8 arrays:
    (q_src, q_dst, q_n, q_e, k_src, k_dst, k_n, k_e).

    `out` may carry preallocated arrays of the right shapes to avoid
    per-call allocation. Requires the native library (no numpy fallback —
    callers fall back to :func:`sample_subgraphs` twice)."""
    lib = _load()
    assert lib is not None, "native sampler library required"
    assert node_cap <= np.iinfo(np.int16).max, (
        f"int16 wire ids require node_cap <= 32767, got {node_cap}"
    )
    s = len(seeds_q)
    if out is None:
        out = tuple(
            np.zeros((s, e_cap), np.int16) if j % 4 < 2
            else np.zeros(s, np.int32)
            for j in range(8)
        )
    q_src, q_dst, q_n, q_e, k_src, k_dst, k_n, k_e = out
    lib.gcc_sample_wire_pairs(
        np.ascontiguousarray(g.indptr, np.int64),
        np.ascontiguousarray(g.indices, np.int32),
        g.num_nodes,
        np.ascontiguousarray(seeds_q, np.int64),
        np.ascontiguousarray(seeds_k, np.int64),
        s,
        np.ascontiguousarray(budgets_q, np.int64),
        np.ascontiguousarray(budgets_k, np.int64),
        float(restart_prob), {"rwr": 0, "ns": 1}[aug], expand, hops,
        rng_seed & (2**64 - 1),
        np.ascontiguousarray(sample_ids, np.int64),
        node_cap, e_cap, n_threads,
        q_src.reshape(-1), q_dst.reshape(-1), q_n, q_e,
        k_src.reshape(-1), k_dst.reshape(-1), k_n, k_e,
        1 if getattr(g, "rows_sorted", False) else 0,
    )
    return out


def native_available() -> bool:
    return _load() is not None


def compact_rows(
    src: np.ndarray, dst: np.ndarray, e: np.ndarray, cap_total: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Flatten padded (rows, e_cap) wire rows into (cap_total,) compact
    buffers (see CompactWireBatch). Returns (src, dst, e_emitted, total);
    rows past a full buffer are truncated (e_emitted records reality).
    numpy fallback mirrors the C++ exactly."""
    rows, e_cap = src.shape
    e = np.ascontiguousarray(e, np.int32)
    out_src = np.zeros(cap_total, np.int16)
    out_dst = np.zeros(cap_total, np.int16)
    e_out = np.zeros(rows, np.int32)
    lib = _load()
    if lib is not None:
        total = np.zeros(1, np.int64)
        lib.gcc_compact_rows(
            np.ascontiguousarray(src, np.int16).reshape(-1),
            np.ascontiguousarray(dst, np.int16).reshape(-1),
            e, rows, e_cap, cap_total,
            out_src, out_dst, e_out, total,
        )
        return out_src, out_dst, e_out, int(total[0])
    off = 0
    for i in range(rows):
        take = min(int(e[i]), cap_total - off)
        if take > 0:
            out_src[off:off + take] = src[i, :take]
            out_dst[off:off + take] = dst[i, :take]
        e_out[i] = take
        off += take
    return out_src, out_dst, e_out, off


class SampledSubgraphs(NamedTuple):
    """Padded per-seed subgraphs in global+local form."""

    nodes: np.ndarray    # (S, node_cap) int32 global ids, row b: first n[b]
    n: np.ndarray        # (S,) int32
    src: np.ndarray      # (S, e_cap) int32 local ids
    dst: np.ndarray      # (S, e_cap) int32
    e: np.ndarray        # (S,) int32 (clamped to e_cap)
    e_full: np.ndarray   # (S,) int64 true edge counts (detect truncation)


def sample_subgraphs(
    g: CSRGraph,
    seeds: np.ndarray,
    budgets: np.ndarray,
    restart_prob: float = 0.8,
    aug: str = "rwr",
    expand: int = 5,
    hops: int = 64,
    rng_seed: int = 0,
    sample_ids: np.ndarray | None = None,
    node_cap: int | None = None,
    e_cap: int | None = None,
    n_threads: int = 1,
    force_numpy: bool = False,
) -> SampledSubgraphs:
    """Fused RWR/NS sampling + induced relabeled subgraph extraction.

    Mirrors the reference pipeline RWR→`_rwr_trace_to_dgl_graph`
    (graph_dataset.py:125-130 + data_util.py:218-231): the returned node
    row starts with the seed, and edges are the induced multi-edges among
    visited nodes in local ids.
    """
    seeds = np.ascontiguousarray(seeds, dtype=np.int64)
    budgets = np.ascontiguousarray(
        np.broadcast_to(np.asarray(budgets, np.int64), seeds.shape)
    )
    s = len(seeds)
    if sample_ids is None:
        sample_ids = np.arange(s, dtype=np.int64)
    sample_ids = np.ascontiguousarray(sample_ids, dtype=np.int64)
    if node_cap is None:
        node_cap = int(budgets.max(initial=1)) + 1
    if e_cap is None:
        e_cap = 32 * node_cap

    nodes = np.zeros((s, node_cap), dtype=np.int32)
    n = np.zeros(s, dtype=np.int32)
    src = np.zeros((s, e_cap), dtype=np.int32)
    dst = np.zeros((s, e_cap), dtype=np.int32)
    e = np.zeros(s, dtype=np.int32)
    e_full = np.zeros(s, dtype=np.int64)

    lib = None if force_numpy else _load()
    aug_code = {"rwr": 0, "ns": 1}[aug]
    if lib is not None:
        lib.gcc_sample_subgraphs(
            np.ascontiguousarray(g.indptr, np.int64),
            np.ascontiguousarray(g.indices, np.int32),
            g.num_nodes, seeds, s, budgets, float(restart_prob), aug_code,
            expand, hops, rng_seed & (2**64 - 1), sample_ids, node_cap, e_cap,
            n_threads, nodes.reshape(-1), n, src.reshape(-1), dst.reshape(-1),
            e, e_full,
            1 if getattr(g, "rows_sorted", False) else 0,
        )
    else:
        _sample_subgraphs_numpy(
            g, seeds, budgets, restart_prob, aug_code, expand, hops, rng_seed,
            sample_ids, node_cap, e_cap, nodes, n, src, dst, e, e_full,
        )
    return SampledSubgraphs(nodes, n, src, dst, e, e_full)


def random_walk_final(
    g: CSRGraph,
    seeds: np.ndarray,
    num_hops: int,
    rng_seed: int = 0,
    sample_ids: np.ndarray | None = None,
    force_numpy: bool = False,
) -> np.ndarray:
    """Final node of a `num_hops` uniform random walk per seed (N3)."""
    seeds = np.ascontiguousarray(seeds, dtype=np.int64)
    s = len(seeds)
    if sample_ids is None:
        sample_ids = np.arange(s, dtype=np.int64)
    sample_ids = np.ascontiguousarray(sample_ids, dtype=np.int64)
    out = np.zeros(s, dtype=np.int64)
    lib = None if force_numpy else _load()
    if lib is not None:
        lib.gcc_random_walk(
            np.ascontiguousarray(g.indptr, np.int64),
            np.ascontiguousarray(g.indices, np.int32),
            g.num_nodes, seeds, s, num_hops, rng_seed & (2**64 - 1),
            sample_ids, out,
        )
    else:
        rng = np.random.default_rng(rng_seed)
        for i, seed in enumerate(seeds):
            cur = int(seed)
            for _ in range(num_hops):
                nbrs = g.neighbors(cur)
                if len(nbrs) == 0:
                    break
                cur = int(nbrs[rng.integers(len(nbrs))])
            out[i] = cur
    return out


def weighted_sample(
    weights: np.ndarray, count: int, rng_seed: int = 0,
    force_numpy: bool = False, cdf: np.ndarray | None = None,
) -> np.ndarray:
    """Draw `count` indices with probability ∝ weights (degree^0.75 seeds).

    Pass a precomputed ``cdf`` (np.cumsum(weights)) for hot loops — the
    cumsum over a corpus-sized weight vector costs more than the draws."""
    lib = None if force_numpy else _load()
    if lib is not None:
        if cdf is None:
            cdf = np.ascontiguousarray(
                np.cumsum(np.asarray(weights, np.float64)))
        out = np.zeros(count, dtype=np.int64)
        lib.gcc_weighted_sample(cdf, len(cdf), count, rng_seed & (2**64 - 1), out)
        return out
    weights = np.asarray(weights, dtype=np.float64)
    rng = np.random.default_rng(rng_seed)
    p = weights / weights.sum()
    return rng.choice(len(weights), size=count, replace=True, p=p)


# --- numpy fallback (same contract, independent implementation) --------------


def _sample_subgraphs_numpy(
    g, seeds, budgets, restart_prob, aug_code, expand, hops, rng_seed,
    sample_ids, node_cap, e_cap, nodes, n, src, dst, e, e_full,
):
    for i, seed in enumerate(seeds):
        rng = np.random.default_rng((rng_seed, int(sample_ids[i])))
        seed = int(seed)
        visited: dict[int, int] = {seed: 0}
        order = [seed]
        if aug_code == 0:
            budget = int(budgets[i])
            visits = 0
            if len(g.neighbors(seed)) > 0:
                while visits < budget and len(order) < node_cap:
                    cur = seed
                    while True:
                        nbrs = g.neighbors(cur)
                        if len(nbrs) == 0:
                            break
                        cur = int(nbrs[rng.integers(len(nbrs))])
                        if cur not in visited:
                            visited[cur] = len(order)
                            order.append(cur)
                        visits += 1
                        if visits >= budget or len(order) >= node_cap:
                            break
                        if rng.random() < restart_prob:
                            break
        else:
            frontier = [seed]
            for _ in range(hops):
                if not frontier:
                    break
                nxt = []
                for u in frontier:
                    nbrs = g.neighbors(u)
                    if len(nbrs) == 0:
                        continue
                    if len(nbrs) <= expand:
                        picks = nbrs
                    else:
                        picks = nbrs[rng.choice(len(nbrs), expand, replace=False)]
                    for v in picks:
                        v = int(v)
                        if v not in visited:
                            if len(order) >= node_cap:
                                continue
                            visited[v] = len(order)
                            order.append(v)
                        nxt.append(v)
                frontier = nxt
        n[i] = len(order)
        nodes[i, : len(order)] = order
        cnt = 0
        for lu, u in enumerate(order):
            for v in g.neighbors(u):
                lv = visited.get(int(v))
                if lv is None:
                    continue
                if cnt < e_cap:
                    src[i, cnt] = lu
                    dst[i, cnt] = lv
                cnt += 1
        e[i] = min(cnt, e_cap)
        e_full[i] = cnt


def sampler_stats(reset: bool = False) -> dict:
    """Cumulative wire-pair sampler phase times (ns) since load/reset:
    {walk_ns, extract_ns, pack_ns, subgraphs}. Cheap always-on C++
    counters — the host-side analog of the device trace."""
    lib = _load()
    if lib is None:
        return {}
    out = np.zeros(4, np.int64)
    lib.gcc_sampler_stats(out, 1 if reset else 0)
    return {"walk_ns": int(out[0]), "extract_ns": int(out[1]),
            "pack_ns": int(out[2]), "subgraphs": int(out[3])}


def compact_pack16(src, dst, n, e, n_batches: int, step: int,
                   e_tot: int):
    """Fused super-batch compaction + uint16 wire packing (n_max <= 256).

    src/dst: (n_batches*step, e_cap) int16; n/e: (n_batches*step,) int32.
    Returns (edges (n_batches, e_tot) uint16, meta (n_batches, 3, step)
    int32, dropped (n_batches,) int64).
    """
    lib = _load()
    e_cap = src.shape[1]
    edges = np.empty((n_batches, e_tot), np.uint16)
    meta = np.empty((n_batches, 3, step), np.int32)
    dropped = np.empty(n_batches, np.int64)
    lib.gcc_compact_pack16(
        np.ascontiguousarray(src), np.ascontiguousarray(dst),
        np.ascontiguousarray(n, np.int32), np.ascontiguousarray(e, np.int32),
        n_batches, step, e_cap, e_tot, edges, meta, dropped,
    )
    return edges, meta, dropped


def pack_rows16(src, dst, n, e, rows, flat, pool_n, pool_e, st):
    """Append selected wire rows, uint16-packed, onto a router class pool
    (see pipeline.py emit="routed"). Mutates flat/pool_n/pool_e/st in
    place; st = int64 {row_off, edge_off}. The caller sizes flat for
    full-e_cap rows, so nothing truncates here."""
    lib = _load()
    rows = np.ascontiguousarray(rows, np.int32)
    lib.gcc_pack_rows16(
        src, dst, np.ascontiguousarray(n, np.int32),
        np.ascontiguousarray(e, np.int32), rows, len(rows), src.shape[1],
        flat, flat.size, pool_n, pool_e, st,
    )
