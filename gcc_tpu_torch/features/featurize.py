"""On-device batch featurization from compact wire batches.

Counterpart of ``gcc_tpu/features/featurize.py`` ``featurize_compact``:
everything the reference stores as DGL ``ndata`` — Laplacian PE,
subgraph in-degree, seed flag — plus the dense adjacency the encoder
aggregates over, derived on the device from the packed edge buffer.
Kernel 1 builds adjacency, degrees and the PE operator for every bucket;
Kernels 2 and 3 compute the PE.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gcc_tpu_torch.features.positional import laplacian_positional_embedding
from gcc_tpu_torch.ops.aggregate import (
    fused_adjacency_featurize,
    node_mask_from_meta,
)


class BatchFeatures(NamedTuple):
    """Device-side derived features for a batch of B graphs."""

    pos: torch.Tensor        # (B, N, pos_size) float32 Laplacian PE
    degrees: torch.Tensor    # (B, N) int32 in-degree (multiplicity counted)
    seed_flag: torch.Tensor  # (B, N) float32
    node_mask: torch.Tensor  # (B, N) float32
    adj: torch.Tensor        # (B, N, N) float32 adjacency A[g, dst, src]

    def map(self, fn) -> "BatchFeatures":
        """Apply ``fn`` to every field (slicing, reshaping, moving)."""
        return BatchFeatures(*(fn(x) for x in self))


def featurize_compact(edges: torch.Tensor, meta: torch.Tensor, n_max: int,
                      id_bits: int, pos_size: int) -> BatchFeatures:
    """Featurize stacked compact wire segments (train-profile PE).

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
    adj, m_shift, deg = fused_adjacency_featurize(edges, meta, n_max, id_bits)
    pos = laplacian_positional_embedding(node_mask, n_nodes, pos_size,
                                         m_shift)
    return BatchFeatures(pos=pos, degrees=deg.to(torch.int32),
                         seed_flag=seed_flag, node_mask=node_mask, adj=adj)
