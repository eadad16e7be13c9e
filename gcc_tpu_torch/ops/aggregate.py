"""Adjacency, degree, aggregation and readout ops over dense subgraph
batches — and Kernel 1, the fused featurize builder.

Counterpart of ``gcc_tpu/ops/aggregate.py`` (plain functions) and
``gcc_tpu/ops/featurize_pallas.py`` (the kernel). Each graph of a batch
is a dense (N, N) adjacency A[g, dst, src] holding edge multiplicities;
GIN aggregation is one batched matmul per layer.

:func:`fused_adjacency_featurize` is the kernel's wrapper: on a CUDA
tensor it launches ``csrc/featurize.cu``; on a CPU tensor it runs
:func:`fused_adjacency_featurize_plain`, the same function as plain
PyTorch (``build_dense_adjacency_compact`` → ``normalized_adjacency`` →
the +I shift of the PE operator). There is no other route.

Storage dtype. The reference's ``GCC_TPU_ADJ_DTYPE=bf16`` stores the
adjacency chain — the adjacency and the PE operator built from it — in
bf16 (``gcc_tpu/ops/aggregate.py:30-45``); here every builder takes it as
``dtype`` (``EncoderConfig.adj_dtype``; float32 by default). The
reference rounds in these places, and so does the port:

* the compact builder scatters +1 increments straight into bf16, which
  counts exactly up to 256 and stays at 256 past it (256 + 1 rounds back
  to 256): an entry is min(count, 256);
* the padded builder counts in integers and casts once;
* the normalized operator is computed in f32 from the stored adjacency
  and rounded once; the shift of m_shift adds the pin and +I to the
  rounded operator in f32 and rounds again, so a real row's diagonal is
  bf16(bf16(a_vv·s_v²) + 1);
* degrees used for the normalization are f32 sums of the stored entries,
  and the train route's degree feature is that sum rounded to bf16
  (``adj.sum(axis=2)`` in the adjacency dtype, ``featurize.py:128``);
* ``aggregate_sum_dense`` rounds h to bf16 and sums in f32.
"""

from __future__ import annotations

import ctypes

import torch

from gcc_tpu_torch.config import STORAGE_DTYPES as _STORAGE_NAMES
from gcc_tpu_torch.ops import build as _build

# Padding nodes get this on the diagonal of M so their eigenvalues sit
# strictly below spec(M) ⊆ [-1, 1] and never enter the top-k.
PAD_EIGENVALUE = -2.0
# The storage dtypes of the adjacency chain and of Kernel 3's V, by the
# names the configuration and the command line use.
STORAGE_DTYPES = dict(zip(_STORAGE_NAMES, (torch.float32, torch.bfloat16)))
# A bf16 count past this no longer moves under a +1 increment.
BF16_COUNT_LIMIT = 256.0


def storage_dtype(dtype) -> torch.dtype:
    """torch.float32 or torch.bfloat16, from a dtype or its name
    ("float32", "bfloat16"); raises on anything else."""
    if isinstance(dtype, torch.dtype):
        if dtype in STORAGE_DTYPES.values():
            return dtype
    elif dtype in STORAGE_DTYPES:
        return STORAGE_DTYPES[dtype]
    raise ValueError(f"storage dtype is one of {sorted(STORAGE_DTYPES)}, "
                     f"got {dtype!r}")


def build_dense_adjacency_compact(edges: torch.Tensor, n_edges: torch.Tensor,
                                  n_max: int, id_bits: int,
                                  dtype=torch.float32) -> torch.Tensor:
    """(S·B, N, N) adjacency A[g, dst, src] in ``dtype`` straight from
    compact wire edges (``gcc_tpu/ops/aggregate.py:102-156``).

    edges: (S, E_tot) packed ``src | dst << id_bits`` (int32); graph j of
    segment s owns slots [cumsum - count, cumsum) of its row, and slots
    past the segment's edge total are ignored. n_edges: (S, B). In bf16
    an entry is min(count, 256), as the reference's bf16 scatter of +1
    increments leaves it."""
    dtype = storage_dtype(dtype)
    s, e_tot = edges.shape
    b = n_edges.shape[1]
    cum = torch.cumsum(n_edges.to(torch.int64), dim=1)               # (S, B)
    e_iota = torch.arange(e_tot, device=edges.device, dtype=torch.int64)
    gid = torch.searchsorted(cum, e_iota.expand(s, e_tot).contiguous(),
                             right=True).clamp_(max=b - 1)           # (S, E)
    mask_bits = (1 << id_bits) - 1
    packed = edges.to(torch.int64)
    src = packed & mask_bits
    dst = (packed >> id_bits) & mask_bits
    live = (e_iota[None, :] < cum[:, -1:]) & (src < n_max) & (dst < n_max)
    ggid = torch.arange(s, device=edges.device)[:, None] * b + gid
    flat = ggid * (n_max * n_max) + dst * n_max + src
    adj = torch.zeros(s * b * n_max * n_max, dtype=torch.float32,
                      device=edges.device)
    tgt = flat[live]
    adj.index_add_(0, tgt, torch.ones(tgt.shape, dtype=torch.float32,
                                      device=edges.device))
    adj = adj.view(s * b, n_max, n_max)
    if dtype == torch.bfloat16:
        adj = torch.clamp_max(adj, BF16_COUNT_LIMIT).to(dtype)
    return adj


def build_dense_adjacency(edges_src: torch.Tensor, edges_dst: torch.Tensor,
                          edge_weight: torch.Tensor, batch_size: int,
                          n_max: int, dtype=torch.float32) -> torch.Tensor:
    """(B, N, N) adjacency A[b, v, u] = Σ weight of edges u→v in ``dtype``
    from the flat padded edge list of a ``PaddedSubgraphBatch``
    (``gcc_tpu/ops/aggregate.py:66-99``; flat node index b·N + i, padding
    edges carry weight 0): summed in f32, cast once, as the reference
    casts its integer counts. One ``index_add_``: this path has no kernel
    in the reference either."""
    flat = edges_dst.to(torch.int64) * n_max + edges_src.to(torch.int64) % n_max
    adj = torch.zeros(batch_size * n_max * n_max, dtype=torch.float32,
                      device=edges_src.device)
    adj.index_add_(0, flat, edge_weight.to(torch.float32))
    return adj.view(batch_size, n_max, n_max).to(storage_dtype(dtype))


def node_degrees(adj: torch.Tensor) -> torch.Tensor:
    """(B, N) in-degree (multiplicity counted) as adjacency row sums in
    f32, whatever the adjacency's dtype — the reference's
    ``subg.in_degrees()`` (``aggregate.py:226-229``)."""
    return adj.sum(dim=2, dtype=torch.float32)


def compact_degrees(adj: torch.Tensor) -> torch.Tensor:
    """The train route's degree feature: the f32 row sum rounded to the
    adjacency's dtype, as ``adj.sum(axis=2)`` in that dtype gives it
    (``featurize.py:128``: JAX sums bf16 in f32 and rounds once). Returned
    in f32: a bf16 in-degree of 257 reads 256, 259 reads 260."""
    return node_degrees(adj).to(adj.dtype).to(torch.float32)


def normalized_adjacency(adj: torch.Tensor,
                         node_mask: torch.Tensor) -> torch.Tensor:
    """M = D^-1/2 A D^-1/2 with degree clipped at 1, padding diagonal
    pinned at -2 (``gcc_tpu/features/positional.py:55-73``): computed in
    f32 and stored in the adjacency's dtype."""
    deg = node_degrees(adj)
    inv_sqrt = torch.rsqrt(torch.clamp_min(deg, 1.0))
    m = adj.to(torch.float32) * inv_sqrt[:, :, None] * inv_sqrt[:, None, :]
    n = node_mask.shape[1]
    eye = torch.eye(n, dtype=m.dtype, device=m.device)
    pad_diag = (1.0 - node_mask) * PAD_EIGENVALUE
    return (m + pad_diag[:, :, None] * eye).to(adj.dtype)


def shifted_operator(m: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """m_shift = M + I on real rows, 0 on the padding diagonal: the -2
    pin moves to -1, then the +I shift sends it to 0 (``_subspace_topk``,
    ``gcc_tpu/features/positional.py:199-206``): added in f32 to the
    stored M and stored in its dtype."""
    n = node_mask.shape[1]
    eye = torch.eye(n, dtype=torch.float32, device=m.device)
    pad = 1.0 - node_mask
    return (m.to(torch.float32) + pad[:, :, None] * eye + eye).to(m.dtype)


def node_mask_from_meta(meta: torch.Tensor, n_max: int) -> torch.Tensor:
    """(S·B, N) float mask of real nodes from (S, 3, B) wire meta."""
    n_nodes = meta[:, 0, :].reshape(-1)
    iota = torch.arange(n_max, device=meta.device, dtype=n_nodes.dtype)
    return (iota[None, :] < n_nodes[:, None]).to(torch.float32)


def fused_adjacency_featurize_plain(edges: torch.Tensor, meta: torch.Tensor,
                                    n_max: int, id_bits: int,
                                    dtype=torch.float32):
    """Plain PyTorch version of Kernel 1: (adj, m_shift, deg) with adj,
    m_shift (S·B, N, N) in ``dtype`` and deg (S·B, N) float32, the train
    route's degree feature (:func:`compact_degrees`: exact in f32, rounded
    to bf16 in bf16)."""
    adj = build_dense_adjacency_compact(edges, meta[:, 1, :], n_max, id_bits,
                                        dtype)
    node_mask = node_mask_from_meta(meta, n_max)
    m_shift = shifted_operator(normalized_adjacency(adj, node_mask),
                               node_mask)
    return adj, m_shift, compact_degrees(adj)


# Kernel 1's launch plan (``csrc/featurize.cu`` make_plan; the CPU tests
# hold these to the source's constants).
FEATURIZE_MAX_N = 2048       # the widest bucket the kernel takes
BAND_MAX_N = 256             # the widest N of the band path
BAND_ROWS = 128              # rows a band block owns at most
COUNT16_LIMIT = 65536        # e_tot below it: 16-bit counts are exact
TILE_ENTRIES = 8192          # counts a tile block holds
FEATURIZE_THREADS = 256      # threads a block, at most
FEATURIZE_VEC = 8            # values a thread stores at once
FEATURIZE_MAX_CLUSTER = 8    # the portable cluster size
MAX_SMEM = 232_448           # shared memory a Hopper block may use


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def featurize_launch_plan(n_max: int, e_tot: int, dtype=torch.float32,
                          cluster: int = 0) -> dict:
    """Launch plan of Kernel 1 for a bucket of ``n_max`` nodes and a wire of
    ``e_tot`` slots a segment, as ``gcc_featurize_plan`` in
    ``csrc/featurize.cu`` computes it:

    * ``path`` "band" (N <= 256 and e_tot < 65536): a thread block
      cluster of ``cluster`` = ceil(N / 128) blocks per graph, each owning
      ``rows`` rows as 16-bit counts in shared memory; every edge is read
      and counted once per graph, one launch;
    * ``path`` "tile" (256 < N <= 2048, or e_tot >= 65536): blocks of
      ``rows`` = 8192 / N' rows (N' = N rounded up to 8) with 32-bit
      counts, ``blocks_per_graph`` of them, two launches (degrees into a
      device scratch of ``scratch_bytes`` a graph, then the stores).

    Both take one rsqrt per node and no division per entry, with threads
    laid out as (N' / 8 threads a row) × (rows at a time), 8 values a
    thread and row; ``store_bytes`` is what one store writes (16 — 4 f32
    or 8 bf16 values — where every row of ``dtype`` values starts 16-byte
    aligned, else 8, 4 or 2 as the rows allow).
    ``smem_bytes``: the counts, their degree sums and inv[] of every
    column. ``cluster`` forces the band path's cluster size (0: the
    plan's). Raises ``ValueError`` with the numbers on what no path
    takes."""
    lo = storage_dtype(dtype) == torch.bfloat16
    if not 0 < n_max <= FEATURIZE_MAX_N or e_tot < 0:
        raise ValueError(f"featurize kernel takes 0 < n_max <= "
                         f"{FEATURIZE_MAX_N} and e_tot >= 0, got n_max="
                         f"{n_max}, e_tot={e_tot}")
    n_pad = _round_up(n_max, FEATURIZE_VEC)
    gx = n_pad // FEATURIZE_VEC
    gy = max(1, FEATURIZE_THREADS // gx)
    size = 2 if lo else 4
    row_bytes = n_max * size
    store = next(w for w in (16, 8, 4, size) if row_bytes % w == 0)
    if n_max <= BAND_MAX_N and e_tot < COUNT16_LIMIT:
        c = cluster or -(-n_max // BAND_ROWS)
        rows = -(-n_max // c) if 1 <= c <= n_max else 0
        smem = rows * n_pad * 2 + 4 * _round_up(rows, 4) + 4 * n_pad
        if not 1 <= c <= min(FEATURIZE_MAX_CLUSTER, n_max) \
                or smem > MAX_SMEM:
            raise ValueError(f"featurize band path takes a cluster of 1 to "
                             f"{FEATURIZE_MAX_CLUSTER} blocks whose band fits "
                             f"{MAX_SMEM} B, got cluster={c} at n_max={n_max}"
                             f" ({smem} B)")
        return dict(path="band", cluster=c, rows=rows, count_bits=16,
                    threads=gx * gy, block=(gx, gy), smem_bytes=smem,
                    blocks_per_graph=c, launches=1, store_bytes=store,
                    scratch_bytes=0)
    if cluster:
        raise ValueError(f"featurize tile path (n_max={n_max}, e_tot={e_tot})"
                         f" takes no cluster, got {cluster}")
    rows = max(1, TILE_ENTRIES // n_pad)
    return dict(path="tile", cluster=1, rows=rows, count_bits=32,
                threads=gx * gy, block=(gx, gy),
                smem_bytes=rows * n_pad * 4 + 4 * _round_up(rows, 4)
                + 4 * n_pad,
                blocks_per_graph=-(-n_max // rows), launches=2,
                store_bytes=store, scratch_bytes=4 * n_max)


_FEATURIZE_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])


def _featurize_lib() -> ctypes.CDLL:
    lib = _build.load("featurize")
    lib.gcc_featurize_launch.argtypes = _FEATURIZE_ARGS
    lib.gcc_featurize_launch.restype = ctypes.c_int
    lib.gcc_featurize_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.gcc_featurize_plan.restype = ctypes.c_int
    return lib


def _check_wire(edges: torch.Tensor, meta: torch.Tensor, id_bits: int):
    if edges.dim() != 2 or meta.dim() != 3 or meta.shape[1] != 3 \
            or meta.shape[0] != edges.shape[0]:
        raise ValueError(f"featurize takes edges (S, E_tot) and meta (S, 3, "
                         f"B), got {tuple(edges.shape)}, {tuple(meta.shape)}")
    if not 1 <= id_bits <= 16:
        raise ValueError(f"featurize takes 1 <= id_bits <= 16, got {id_bits}")


def fused_adjacency_featurize(edges: torch.Tensor, meta: torch.Tensor,
                              n_max: int, id_bits: int, dtype=torch.float32):
    """Kernel 1 wrapper. edges (S, E_tot) int32 packed, meta (S, 3, B)
    int32 → (adj, m_shift, deg), adj and m_shift in ``dtype`` (float32 or
    bfloat16), deg float32. CUDA tensors launch ``csrc/featurize.cu`` by
    :func:`featurize_launch_plan` (and count one launch); CPU tensors run
    :func:`fused_adjacency_featurize_plain`. Raises, with the numbers, on
    wire shapes and, on the card, on widths no path takes."""
    dtype = storage_dtype(dtype)
    _check_wire(edges, meta, id_bits)
    if edges.device.type == "cpu":
        return fused_adjacency_featurize_plain(edges, meta, n_max, id_bits,
                                               dtype)
    return _launch(edges, meta, n_max, id_bits, dtype)


def _launch(edges: torch.Tensor, meta: torch.Tensor, n_max: int,
            id_bits: int, dtype, cluster: int = 0):
    """Launch Kernel 1 on CUDA tensors; ``cluster`` forces the band path's
    cluster size (0: the plan's)."""
    if edges.device.type != "cuda":
        raise ValueError(f"unsupported device {edges.device}")
    if edges.dtype != torch.int32 or meta.dtype != torch.int32:
        raise TypeError(f"fused_adjacency_featurize takes int32 edges/meta, "
                        f"got {edges.dtype}, {meta.dtype}")
    if meta.device != edges.device:
        raise ValueError("edges and meta must be on the same device")
    dtype = storage_dtype(dtype)
    edges, meta = edges.contiguous(), meta.contiguous()
    s, e_tot = edges.shape
    plan = featurize_launch_plan(n_max, e_tot, dtype, cluster)
    b = meta.shape[2]
    dev = edges.device
    adj = torch.empty((s * b, n_max, n_max), dtype=dtype, device=dev)
    m_shift = torch.empty_like(adj)
    deg = torch.empty((s * b, n_max), dtype=torch.float32, device=dev)
    scratch = torch.empty((s * b * plan["scratch_bytes"] // 4,),
                          dtype=torch.float32, device=dev)
    lib = _featurize_lib()
    with torch.cuda.device(dev):
        err = lib.gcc_featurize_launch(
            edges.data_ptr(), meta.data_ptr(), adj.data_ptr(),
            m_shift.data_ptr(), deg.data_ptr(), scratch.data_ptr(), s, e_tot,
            b, n_max, id_bits, 1 if dtype == torch.bfloat16 else 0, cluster,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "featurize")
    fused_adjacency_featurize.launches += 1
    return adj, m_shift, deg


fused_adjacency_featurize.launches = 0


def aggregate_sum_dense(h: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """Batched A @ h: out[g, v] = Σ_u A[g, v, u] h[g, u], float32.

    With a bf16 adjacency h is rounded to bf16 too and the products are
    summed in f32 (``aggregate.py:171-184``): both operands are widened
    first, so the product runs in f32 (a bf16 ``bmm`` would round its
    output). Autograd rounds the gradient of h to bf16 on its way back
    through the cast, as JAX's VJP of the convert does."""
    if adj.dtype == torch.bfloat16:
        return torch.bmm(adj.to(torch.float32),
                         h.to(torch.bfloat16).to(torch.float32))
    return torch.bmm(adj, h)


def graph_pool_sum(h: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """Per-graph sum readout (DGL SumPooling): (B, N, F), (B, N) → (B, F)."""
    return torch.einsum("bnf,bn->bf", h, node_mask)


def graph_pool_mean(h: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """Per-graph masked mean readout (DGL AvgPooling)."""
    counts = torch.clamp_min(node_mask.sum(dim=1, keepdim=True), 1.0)
    return graph_pool_sum(h, node_mask) / counts


def graph_pool_max(h: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """Per-graph masked max readout (DGL MaxPooling); a graph without
    nodes reads 0."""
    neg = torch.where(node_mask[..., None] > 0, h,
                      torch.full_like(h, float("-inf")))
    out = neg.amax(dim=1)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))
