"""Giant-graph featurization: whole-graph Laplacian PE + degree
embedding + seed flag over a partitioned graph, and the end-to-end
embedding of one graph beyond the dense bucket.

Counterpart of ``gcc_tpu/parallel/giant_features.py``. The PE is the
subspace iteration of ``features/positional.py`` with a partitioned
aggregation as its matvec: with edge weights w(u→v) = 1/sqrt(d_u·d_v)
one aggregation is one power step of M = D^-1/2 A D^-1/2. It runs in
f32 throughout (no bf16 rounds, and no TF32: the port sets no global
switch), orthonormalizes by CholeskyQR on the global (k, k) Gram, and
finishes with the guarded generalized Rayleigh–Ritz of the eval profile,
whose two small eigenproblems are Kernel 3 (``ops/jacobi.py``) at
(1, 48, 48) with 5 sweeps at the canonical widths. The conventions are
positional.py's: descending eigenvalue order, max-|entry| sign
canonicalization, column cutoff k_b = min(n - 2, pos_size), row-L2
normalization, zero padding rows.

The reference's ``pg_arrays``, ``pg_rebuild``, ``_giant_pe_fn`` and
``_giant_enc_fn`` exist only to feed and cache ``jax.jit`` programs and
have no counterpart: PyTorch runs eagerly. A partition count ``parts``
takes the place of the reference's mesh (its "part" axis). The D shards
run in one process (:mod:`gcc_tpu_torch.parallel.partitioned`), or,
given a ``torch.distributed`` group of D ranks, one shard a rank: each
rank holds a contiguous block of N_pad / D node rows and only its shard
of the partition (:func:`~gcc_tpu_torch.parallel.partitioned.
place_shard`). Then every reduction over rows runs across the ranks —
CholeskyQR's column norms (the norm of the ranks' norms) and Gram, the
whitening Gram, the Rayleigh–Ritz matrix, the sign rule's column max and
sum, the readout — so Cholesky, the triangular solve's factor and Kernel
3 see the same bits on every rank, and every rank returns the same
embedding. In one process those reductions are the identity, one code
path for both; at world size 1 the path gives the one-process bits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from gcc_tpu_torch.device import resolve_device
from gcc_tpu_torch.features.positional import (
    canonical_pe,
    guarded_whitening,
    pe_guards,
)
from gcc_tpu_torch.ops.jacobi import jacobi_eigh
from gcc_tpu_torch.parallel import data_parallel as dp
from gcc_tpu_torch.parallel.giant import (
    aggregate_for,
    check_giant_encoder,
    giant_gin_encode,
)
from gcc_tpu_torch.parallel.partitioned import (
    DensePartitionedGraph,
    RingPartitionedGraph,
    partition_dense,
    partition_edges_ring,
    place_partition,
    place_shard,
    shard_dense_partition,
)


def dense_schedule_wins(num_edges, num_nodes, num_devices,
                        dense_budget_bytes=512 << 20) -> bool:
    """The reference's dense/ring policy in one place
    (``giant_features.py:81-101``, measured on its TPU and not retuned):
    the dense row-block schedule when N <= 4096 or the density is at
    least 0.4%, provided the per-shard (N/D, N) f32 block fits
    `dense_budget_bytes`; the ring schedule otherwise."""
    density = num_edges / max(1, num_nodes) ** 2
    n_pad = -(-num_nodes // num_devices) * num_devices
    dense_bytes = n_pad * (n_pad // num_devices) * 4
    return ((num_nodes <= 4096 or density >= 0.004)
            and dense_bytes <= dense_budget_bytes)


def choose_partition(src, dst, num_nodes, num_devices, weight=None,
                     dense_budget_bytes=512 << 20):
    """The schedule :func:`dense_schedule_wins` picks, as a host
    partition."""
    if dense_schedule_wins(len(src), num_nodes, num_devices,
                           dense_budget_bytes):
        return partition_dense(src, dst, num_nodes, num_devices,
                               weight=weight)
    return partition_edges_ring(src, dst, num_nodes, num_devices,
                                weight=weight)


def normalized_edge_weights(src, dst, degrees):
    """w(u→v) = 1/sqrt(d_u · d_v) with degree clipped at 1, in f64 and
    rounded once to f32 — the entries of M = D^-1/2 A D^-1/2 (reference
    data_util.py:273-277)."""
    inv_sqrt = 1.0 / np.sqrt(np.maximum(degrees.astype(np.float64), 1.0))
    return (inv_sqrt[src] * inv_sqrt[dst]).astype(np.float32)


def cholesky_or_nan(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of `a`, NaN over its lower triangle where
    the factorization fails (a matrix that is not positive definite), as
    ``jnp.linalg.cholesky`` returns it; ``torch.linalg.cholesky`` would
    raise. Decided on the device, with no host sync."""
    r, info = torch.linalg.cholesky_ex(a)
    return torch.where(info != 0, torch.full_like(r, float("nan")).tril(), r)


def _all_sum(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else dp.all_reduce_sum(x, group)


def _all_max(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else dp.all_reduce_max(x, group)


def _column_norms(q: torch.Tensor, group) -> torch.Tensor:
    """(1, k) 2-norms of the columns of q, whose rows may be spread over
    the ranks of ``group``: the norm of the ranks' norms (gathered), which
    at world size 1 is the one-process norm bit for bit."""
    norms = torch.linalg.vector_norm(q, dim=0, keepdim=True)
    if group is None:
        return norms
    return torch.linalg.vector_norm(dp.all_gather(norms, group), dim=0,
                                    keepdim=True)


def _orth_chol(q: torch.Tensor, group=None) -> torch.Tensor:
    """CholeskyQR on the global (k, k) Gram (``giant_features.py:
    154-164``): normalize the columns, Gram + 1e-6·I, factor, solve
    X·Rᵀ = Q; a failed factor's NaNs become zeros. With ``group``, q is
    this rank's rows, its norms are gathered and its Gram all-reduced."""
    k = q.shape[1]
    q = q / torch.clamp_min(_column_norms(q, group), 1e-20)
    r = cholesky_or_nan(_all_sum(q.T @ q, group)
                        + 1e-6 * torch.eye(k, dtype=q.dtype,
                                           device=q.device))
    q = torch.linalg.solve_triangular(r.T, q, upper=True, left=False)
    return torch.nan_to_num(q, nan=0.0, posinf=0.0, neginf=0.0)


def _shifted_matvec(pg, group=None):
    aggregate = aggregate_for(pg, group)

    def matvec(q):
        # One power step of the SHIFTED operator M + I: spec(M) ⊆ [-1, 1]
        # moves to [0, 2], so modulus order is algebraic order. Padding
        # rows have no edges and zero q, so they stay exactly zero.
        return aggregate(pg, q) + q

    return matvec


def giant_pe_iterate(pg, q0: torch.Tensor, iters: int = 64,
                     orth_every: int = 8, group=None) -> torch.Tensor:
    """The subspace iteration of :func:`giant_laplacian_pe`: CholeskyQR
    of q0, `iters` shifted power steps re-orthonormalized every
    `orth_every` (not after the last), CholeskyQR. Returns the (N_pad, k)
    basis the Rayleigh–Ritz finish starts from (this rank's rows of it
    with ``group``)."""
    matvec = _shifted_matvec(pg, group)
    q = _orth_chol(q0, group)
    for i in range(iters):
        q = matvec(q)
        if (i + 1) % orth_every == 0 and i != iters - 1:
            q = _orth_chol(q, group)
    return _orth_chol(q, group)


def giant_pe_finish(pg, q: torch.Tensor, node_mask: torch.Tensor,
                    num_real_nodes: int, pos_size: int = 32,
                    group=None) -> torch.Tensor:
    """The Rayleigh–Ritz finish of :func:`giant_laplacian_pe` on the
    iterated basis q (N_pad, k), k even: the guarded generalized whitening
    when k exceeds the kept width, Ritz vectors, then positional.py's
    conventions (:func:`~gcc_tpu_torch.features.positional.canonical_pe`).
    Kernel 3 solves its two (1, k, k) eigenproblems (5 sweeps), on the
    all-reduced matrices with ``group`` (q and node_mask this rank's
    rows). The reference's branch for an odd k (``jnp.linalg.eigh``) has
    no counterpart: :func:`giant_pe_basis` always gives an even width,
    and Kernel 3 raises on an odd one."""
    matvec = _shifted_matvec(pg, group)
    all_sum = functools.partial(_all_sum, group=group)
    k_keep = min(pos_size, max(1, num_real_nodes))
    if q.shape[1] > k_keep:
        q = guarded_whitening(q[None], 1e-6,
                              lambda s: jacobi_eigh(s, descending=True),
                              all_sum)[0]
    # Rayleigh–Ritz on M + I (the shift changes neither eigenvectors nor
    # their order).
    t = all_sum(q.T @ matvec(q))
    t = 0.5 * (t + t.T)
    _, u = jacobi_eigh(t[None], descending=True)
    n_real = torch.full((1,), num_real_nodes, device=q.device)
    return canonical_pe((q @ u[0, :, :k_keep])[None], n_real,
                        node_mask[None], pos_size,
                        all_max=functools.partial(_all_max, group=group),
                        all_sum=all_sum)[0]


def giant_laplacian_pe(pg, q0: torch.Tensor, node_mask: torch.Tensor,
                       num_real_nodes: int, pos_size: int = 32,
                       iters: int = 64, orth_every: int = 8,
                       group=None) -> torch.Tensor:
    """Top-`pos_size` eigenvectors of M for one partitioned giant graph
    (``giant_features.py:110-228``): :func:`giant_pe_iterate` then
    :func:`giant_pe_finish`.

    pg carries the NORMALIZED edge weights (:func:`normalized_edge_weights`)
    on q0's device, so one aggregation is one power step. q0: (N_pad, k)
    start basis (:func:`giant_pe_basis`; guarded whitening engages when k
    exceeds pos_size); node_mask: (N_pad,) 1.0 on real rows. With
    ``group`` (the partition axis across its ranks), pg is this rank's
    :class:`~gcc_tpu_torch.parallel.partitioned.PartitionShard` (or the
    whole partition) and q0, node_mask are its block of N_pad / D rows.
    Returns (N_pad, pos_size) f32 (this rank's rows with ``group``)."""
    return giant_pe_finish(pg, giant_pe_iterate(pg, q0, iters, orth_every,
                                                group),
                           node_mask, num_real_nodes, pos_size, group)


def giant_pe_basis(n_pad: int, num_real_nodes: int, pos_size: int = 32,
                   guards: int = 16) -> np.ndarray:
    """Deterministic (N_pad, k) start basis: the fixed-seed numpy draw of
    positional.py's q0, zero on padding rows; k = pos_size + guards
    rounded even for the paired Jacobi finish."""
    k = pos_size + max(0, guards)
    k += k % 2
    q0 = np.random.default_rng(2).standard_normal((n_pad, k))
    q0[num_real_nodes:] = 0.0
    return np.ascontiguousarray(q0, np.float32)


def _bucket_ring(pg: RingPartitionedGraph) -> RingPartitionedGraph:
    """Pad the ring bucket width to the next power of two (0→0 loops of
    weight 0), as the reference does so that similar graphs share one
    compiled shape. (:func:`~gcc_tpu_torch.parallel.partitioned.
    place_partition` drops that padding again on the device.)"""
    e_b = pg.src_local.shape[-1]
    e_pow = 1 << (e_b - 1).bit_length()
    if e_pow == e_b:
        return pg
    pad = ((0, 0), (0, 0), (0, e_pow - e_b))
    return pg._replace(
        src_local=np.pad(pg.src_local, pad),
        dst_local=np.pad(pg.dst_local, pad),
        weight=np.pad(pg.weight, pad),
    )


def giant_partitions(g, parts: int = 1, dense_budget_bytes: int = 512 << 20):
    """Host partitions of graph `g` for the PE (normalized edge weights)
    and for the encoder (unit weights), in the schedule
    :func:`dense_schedule_wins` picks, with the reference's shape
    bucketing (``giant_features.py:269-296``): on the ring schedule the
    padded node count is rounded up to a multiple of 256·parts and the
    bucket width to a power of two; the dense partition stays exact."""
    n = g.num_nodes
    deg = np.diff(g.indptr).astype(np.int64)
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    dst = np.asarray(g.indices, np.int64)
    n_pad_hint = n
    if not dense_schedule_wins(len(src), n, parts, dense_budget_bytes):
        step = 256 * parts
        n_pad_hint = -(-n // step) * step
    w_pe = normalized_edge_weights(src, dst, deg)
    pg_pe = choose_partition(src, dst, n_pad_hint, parts, weight=w_pe,
                             dense_budget_bytes=dense_budget_bytes)
    pg_enc = choose_partition(src, dst, n_pad_hint, parts,
                              dense_budget_bytes=dense_budget_bytes)
    if isinstance(pg_pe, RingPartitionedGraph):
        pg_pe, pg_enc = _bucket_ring(pg_pe), _bucket_ring(pg_enc)
    return pg_pe, pg_enc


def place_giant_partition(pg, parts: int, device="cuda"):
    """A host partition from :func:`giant_partitions` on `device` (the
    dense one through :func:`shard_dense_partition`'s check of `parts`)."""
    if isinstance(pg, DensePartitionedGraph):
        return shard_dense_partition(pg, parts, device)
    return place_partition(pg, device)


def _require_degree_input(model) -> None:
    # The reference's giant path reads DegreeEmbedding_0 unconditionally
    # (giant_features.py:314).
    if not model.cfg.degree_input:
        raise ValueError(
            "the giant-graph path feeds the degree embedding "
            "(degree_input=True); this encoder has none — raise n_max to "
            "cover the graphs on the dense path")


def giant_input_features(model, g, pe: torch.Tensor,
                         row0: int = 0) -> torch.Tensor:
    """(rows, pos + deg_size + 1) node features of graph `g` on pe's
    device: [PE, degree embedding of clamp(deg, 0, max_degree), seed flag
    on the max-degree node] (sampler.entire_graph_subgraph's seed), zero
    on padding rows, as the subgraph featurizer builds them. pe holds the
    rows from global row `row0` on (a rank's block across ranks; all
    N_pad rows in one process); the seed flag is set where its row is
    among them."""
    _require_degree_input(model)
    n, (rows, pos) = g.num_nodes, pe.shape
    deg = np.diff(g.indptr).astype(np.int64)
    lo, hi = min(row0, n), min(row0 + rows, n)
    table = model.degree_embedding.embedding.weight
    idx = torch.as_tensor(np.clip(deg[lo:hi], 0, table.shape[0] - 1),
                          device=pe.device)
    feats = torch.zeros(rows, pos + table.shape[1] + 1, dtype=pe.dtype,
                        device=pe.device)
    feats[:hi - lo, :pos] = pe[:hi - lo]
    feats[:hi - lo, pos:-1] = table[idx]
    seed = int(np.argmax(deg)) if n else 0
    if row0 <= seed < row0 + rows:
        feats[seed - row0, -1] = 1.0
    return feats


def _group_rank(group) -> tuple[int, int]:
    """(size, rank) of ``group``; (1, 0) in one process (None)."""
    if group is None:
        return 1, 0
    if not dist.is_initialized():
        raise RuntimeError(
            "the giant path across ranks needs an initialized process "
            "group (parallel.multihost.initialize_multihost)")
    return dist.get_world_size(group), dist.get_rank(group)


def giant_graph_embedding(model, g, parts: int | None = None,
                          iters: int = 64, guards: int | None = None,
                          dense_budget_bytes: int = 512 << 20,
                          group=None, device="cuda") -> torch.Tensor:
    """End-to-end entire-graph embedding of one graph beyond the dense
    bucket (``giant_features.py:243-337``): partition → whole-graph PE
    → degree embedding + seed flag → :func:`giant_gin_encode`.

    model: the port's ``GraphEncoder`` (GIN with BatchNorm and degree
    input; others raise ``ValueError``), on `device`. parts: the
    partition count (the reference's mesh "part" axis; default 1, or the
    group's size). group: a ``torch.distributed`` group whose ranks take
    one shard each (``parts`` must equal its size): every rank builds the
    host partitions, as the reference's single controller does, places
    only its own shard, and computes its block of rows; every rank
    returns the same embedding. guards: PE guard columns (default: the
    eval profile's 16). Returns the (output_dim,) L2-normalized embedding
    on `device`, without a host sync."""
    device = resolve_device(device)
    check_giant_encoder(model)
    _require_degree_input(model)
    world, rank = _group_rank(group)
    if parts is None:
        parts = world
    if group is not None and parts != world:
        raise ValueError(f"{parts} partitions across a group of {world} "
                         "ranks: the partition axis takes one shard a rank")
    if next(model.parameters()).device.type != device.type:
        raise ValueError(f"the encoder lives on "
                         f"{next(model.parameters()).device}, not {device}")
    if guards is None:
        guards = pe_guards("eval")
    n = g.num_nodes
    pg_pe, pg_enc = giant_partitions(g, parts, dense_budget_bytes)
    n_pad = pg_pe.num_nodes
    if group is None:
        pg_pe, pg_enc = (place_giant_partition(pg, parts, device)
                         for pg in (pg_pe, pg_enc))
        lo, hi = 0, n_pad
    else:
        pg_pe, pg_enc = (place_shard(pg, rank, device)
                         for pg in (pg_pe, pg_enc))
        lo, hi = rank * n_pad // parts, (rank + 1) * n_pad // parts
    pos_size = model.cfg.positional_embedding_size
    q0 = torch.as_tensor(giant_pe_basis(n_pad, n, pos_size, guards)[lo:hi],
                         device=device)
    mask = (torch.arange(lo, hi, device=device) < n).to(torch.float32)
    with torch.no_grad():
        pe = giant_laplacian_pe(pg_pe, q0, mask, num_real_nodes=n,
                                pos_size=pos_size, iters=iters, group=group)
        return giant_gin_encode(model, pg_enc,
                                giant_input_features(model, g, pe, lo), mask,
                                group=group)
