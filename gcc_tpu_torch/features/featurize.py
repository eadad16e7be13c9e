"""On-device batch featurization.

Counterpart of ``gcc_tpu/features/featurize.py``: everything the
reference stores as DGL ``ndata`` — Laplacian PE, subgraph in-degree,
seed flag — plus the dense adjacency the encoder aggregates over,
derived on the device. :func:`featurize_compact` (pre-training) starts
from the sampler's packed edge buffer: Kernel 1 builds adjacency,
degrees and the PE operator for every bucket. :func:`featurize_batch`
(embedding generation) starts from a padded host batch of arbitrary
subgraphs and builds the adjacency with one ``index_add_``, as the
reference builds it outside any kernel on that path. Kernels 2 and 3
compute the PE on both.

``adj_dtype`` and ``v_dtype`` (``EncoderConfig.adj_dtype`` and
``jacobi_v_dtype``; the reference's ``GCC_TPU_ADJ_DTYPE`` and
``GCC_TPU_JACOBI_V_DTYPE``) store the adjacency chain and Kernel 3's Vᵀ
in bf16. ``guards`` (``EncoderConfig.pe_guards``; the reference's
``GCC_TPU_PE_GUARDS``) reaches the PE unchanged: None keeps the
profile's own guard columns.
The degree feature follows each route as the reference's does:
:func:`featurize_compact` takes the row sum in the adjacency's dtype
(``featurize.py:128``: rounded to bf16, so an in-degree of 257 reads
256), :func:`featurize_batch` in f32 (``featurize.py:41``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gcc_tpu_torch.device import resolve_device
from gcc_tpu_torch.features.positional import laplacian_positional_embedding
from gcc_tpu_torch.graph.batch import PaddedSubgraphBatch
from gcc_tpu_torch.ops.aggregate import (
    build_dense_adjacency,
    fused_adjacency_featurize,
    node_degrees,
    node_mask_from_meta,
)


class BatchFeatures(NamedTuple):
    """Device-side derived features for a batch of B graphs."""

    pos: torch.Tensor        # (B, N, pos_size) float32 Laplacian PE
    degrees: torch.Tensor    # (B, N) int32 in-degree (multiplicity counted)
    seed_flag: torch.Tensor  # (B, N) float32
    node_mask: torch.Tensor  # (B, N) float32
    adj: torch.Tensor        # (B, N, N) adjacency A[g, dst, src], f32 or bf16

    def map(self, fn) -> "BatchFeatures":
        """Apply ``fn`` to every field (slicing, reshaping, moving)."""
        return BatchFeatures(*(fn(x) for x in self))


def featurize_batch(batch: PaddedSubgraphBatch, pos_size: int,
                    pe_method: str = "eigh", profile: str = "train",
                    device="cuda", adj_dtype=torch.float32,
                    v_dtype=torch.float32, guards=None) -> BatchFeatures:
    """Upload a padded host batch and featurize it
    (``featurize.py:32-48``). ``profile`` selects the subspace PE's guard
    columns ("train" → 0, "eval" → 16) unless ``guards`` is given; the
    eigh method ignores both."""
    device = resolve_device(device)

    def up(x):
        return torch.as_tensor(x).to(device, non_blocking=True)

    node_mask = up(batch.node_mask)
    adj = build_dense_adjacency(up(batch.edges_src), up(batch.edges_dst),
                                up(batch.edge_weight), batch.batch_size,
                                batch.n_max, adj_dtype)
    pos = laplacian_positional_embedding(
        node_mask, up(batch.n_nodes), pos_size, adj=adj, method=pe_method,
        profile=profile, v_dtype=v_dtype, guards=guards)
    return BatchFeatures(pos=pos, degrees=node_degrees(adj).to(torch.int32),
                         seed_flag=up(batch.seed_flag), node_mask=node_mask,
                         adj=adj)


def featurize_compact(edges: torch.Tensor, meta: torch.Tensor, n_max: int,
                      id_bits: int, pos_size: int,
                      pe_method: str = "subspace",
                      profile: str = "train", adj_dtype=torch.float32,
                      v_dtype=torch.float32, guards=None) -> BatchFeatures:
    """Featurize stacked compact wire segments (``featurize.py:76-134``).

    Args:
      edges: (S, E_tot) int32 packed edges (S wire segments of B graphs).
      meta:  (S, 3, B) int32 — rows n_nodes, n_edges, seed_pos.
    Returns: BatchFeatures with (S·B, ...) fields.
    """
    n_nodes = meta[:, 0, :].reshape(-1)
    seed_pos = meta[:, 2, :].reshape(-1)
    node_mask = node_mask_from_meta(meta, n_max)
    iota = torch.arange(n_max, device=meta.device, dtype=meta.dtype)
    seed_flag = (iota[None, :] == seed_pos[:, None]).to(torch.float32) \
        * node_mask
    adj, m_shift, deg = fused_adjacency_featurize(edges, meta, n_max, id_bits,
                                                  adj_dtype)
    pos = laplacian_positional_embedding(node_mask, n_nodes, pos_size,
                                         m_shift, adj=adj, method=pe_method,
                                         profile=profile, v_dtype=v_dtype,
                                         guards=guards)
    return BatchFeatures(pos=pos, degrees=deg.to(torch.int32),
                         seed_flag=seed_flag, node_mask=node_mask, adj=adj)
