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
"""

from __future__ import annotations

import ctypes

import torch

from gcc_tpu_torch.ops import build as _build

# Padding nodes get this on the diagonal of M so their eigenvalues sit
# strictly below spec(M) ⊆ [-1, 1] and never enter the top-k.
PAD_EIGENVALUE = -2.0


def build_dense_adjacency_compact(edges: torch.Tensor, n_edges: torch.Tensor,
                                  n_max: int, id_bits: int) -> torch.Tensor:
    """(S·B, N, N) float32 adjacency A[g, dst, src] straight from compact
    wire edges (``gcc_tpu/ops/aggregate.py:102-156``).

    edges: (S, E_tot) packed ``src | dst << id_bits`` (int32); graph j of
    segment s owns slots [cumsum - count, cumsum) of its row, and slots
    past the segment's edge total are ignored. n_edges: (S, B)."""
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
    return adj.view(s * b, n_max, n_max)


def build_dense_adjacency(edges_src: torch.Tensor, edges_dst: torch.Tensor,
                          edge_weight: torch.Tensor, batch_size: int,
                          n_max: int) -> torch.Tensor:
    """(B, N, N) float32 adjacency A[b, v, u] = Σ weight of edges u→v
    from the flat padded edge list of a ``PaddedSubgraphBatch``
    (``gcc_tpu/ops/aggregate.py:66-99``; flat node index b·N + i, padding
    edges carry weight 0). One ``index_add_``: this path has no kernel in
    the reference either."""
    flat = edges_dst.to(torch.int64) * n_max + edges_src.to(torch.int64) % n_max
    adj = torch.zeros(batch_size * n_max * n_max, dtype=torch.float32,
                      device=edges_src.device)
    adj.index_add_(0, flat, edge_weight.to(torch.float32))
    return adj.view(batch_size, n_max, n_max)


def node_degrees(adj: torch.Tensor) -> torch.Tensor:
    """(B, N) in-degree (multiplicity counted) as adjacency row sums —
    the reference's ``subg.in_degrees()``."""
    return adj.sum(dim=2, dtype=torch.float32)


def normalized_adjacency(adj: torch.Tensor,
                         node_mask: torch.Tensor) -> torch.Tensor:
    """M = D^-1/2 A D^-1/2 with degree clipped at 1, padding diagonal
    pinned at -2 (``gcc_tpu/features/positional.py:55-73``)."""
    deg = node_degrees(adj)
    inv_sqrt = torch.rsqrt(torch.clamp_min(deg, 1.0))
    m = adj * inv_sqrt[:, :, None] * inv_sqrt[:, None, :]
    n = node_mask.shape[1]
    eye = torch.eye(n, dtype=m.dtype, device=m.device)
    pad_diag = (1.0 - node_mask) * PAD_EIGENVALUE
    return m + pad_diag[:, :, None] * eye


def shifted_operator(m: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """m_shift = M + I on real rows, 0 on the padding diagonal: the -2
    pin moves to -1, then the +I shift sends it to 0 (``_subspace_topk``,
    ``gcc_tpu/features/positional.py:199-206``)."""
    n = node_mask.shape[1]
    eye = torch.eye(n, dtype=m.dtype, device=m.device)
    pad = 1.0 - node_mask
    return m + pad[:, :, None] * eye + eye


def node_mask_from_meta(meta: torch.Tensor, n_max: int) -> torch.Tensor:
    """(S·B, N) float mask of real nodes from (S, 3, B) wire meta."""
    n_nodes = meta[:, 0, :].reshape(-1)
    iota = torch.arange(n_max, device=meta.device, dtype=n_nodes.dtype)
    return (iota[None, :] < n_nodes[:, None]).to(torch.float32)


def fused_adjacency_featurize_plain(edges: torch.Tensor, meta: torch.Tensor,
                                    n_max: int, id_bits: int):
    """Plain PyTorch version of Kernel 1: (adj, m_shift, deg) with
    adj, m_shift (S·B, N, N) float32 and deg (S·B, N) float32."""
    adj = build_dense_adjacency_compact(edges, meta[:, 1, :], n_max, id_bits)
    node_mask = node_mask_from_meta(meta, n_max)
    m_shift = shifted_operator(normalized_adjacency(adj, node_mask),
                               node_mask)
    return adj, m_shift, node_degrees(adj)


_FEATURIZE_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _featurize_lib() -> ctypes.CDLL:
    lib = _build.load("featurize")
    lib.gcc_featurize_launch.argtypes = _FEATURIZE_ARGS
    lib.gcc_featurize_launch.restype = ctypes.c_int
    return lib


def fused_adjacency_featurize(edges: torch.Tensor, meta: torch.Tensor,
                              n_max: int, id_bits: int):
    """Kernel 1 wrapper. edges (S, E_tot) int32 packed, meta (S, 3, B)
    int32 → (adj, m_shift, deg). CUDA tensors launch
    ``csrc/featurize.cu`` (and count one launch); CPU tensors run
    :func:`fused_adjacency_featurize_plain`."""
    if edges.device.type == "cpu":
        return fused_adjacency_featurize_plain(edges, meta, n_max, id_bits)
    if edges.device.type != "cuda":
        raise ValueError(f"unsupported device {edges.device}")
    if edges.dtype != torch.int32 or meta.dtype != torch.int32:
        raise TypeError("fused_adjacency_featurize takes int32 edges/meta")
    if edges.dim() != 2 or meta.dim() != 3 or meta.shape[1] != 3 \
            or meta.shape[0] != edges.shape[0]:
        raise ValueError(f"bad wire shapes {tuple(edges.shape)}, "
                         f"{tuple(meta.shape)}")
    if meta.device != edges.device:
        raise ValueError("edges and meta must be on the same device")
    if not 0 < n_max <= 2048:
        raise ValueError(f"featurize kernel takes n_max <= 2048, got {n_max}")
    edges, meta = edges.contiguous(), meta.contiguous()
    s, e_tot = edges.shape
    b = meta.shape[2]
    dev = edges.device
    adj = torch.empty((s * b, n_max, n_max), dtype=torch.float32, device=dev)
    m_shift = torch.empty_like(adj)
    deg = torch.empty((s * b, n_max), dtype=torch.float32, device=dev)
    lib = _featurize_lib()
    with torch.cuda.device(dev):
        err = lib.gcc_featurize_launch(
            edges.data_ptr(), meta.data_ptr(), adj.data_ptr(),
            m_shift.data_ptr(), deg.data_ptr(), s, e_tot, b, n_max, id_bits,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "featurize")
    fused_adjacency_featurize.launches += 1
    return adj, m_shift, deg


fused_adjacency_featurize.launches = 0


def aggregate_sum_dense(h: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """Batched A @ h: out[g, v] = Σ_u A[g, v, u] h[g, u]."""
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
