"""GCN encoder (reference gcc/models/gcn.py:17-66 — dead code there: the
GraphEncoder never dispatches to it; kept for completeness).

Counterpart of ``gcc_tpu/models/gcn.py``: per layer h ← ReLU(D^-1/2
(A+I) D^-1/2 (h W)), then a masked mean readout ("avg") or the seed
node's row ("root"), optionally layer-normalized (Flax's LayerNorm,
eps 1e-6).
"""

from __future__ import annotations

import torch
from torch import nn

from gcc_tpu_torch.models.layers import init_linear_
from gcc_tpu_torch.ops.aggregate import aggregate_sum_dense, graph_pool_mean


class UnsupervisedGCN(nn.Module):
    def __init__(self, input_dim: int, node_hidden_dim: int = 64,
                 num_layers: int = 2, readout: str = "avg",
                 layernorm: bool = False):
        super().__init__()
        if readout not in ("avg", "root"):
            raise ValueError(f"unknown GCN readout: {readout}")
        self.readout = readout
        self.layers = nn.ModuleList(
            nn.Linear(input_dim if i == 0 else node_hidden_dim,
                      node_hidden_dim) for i in range(num_layers))
        self.norm = nn.LayerNorm(node_hidden_dim, eps=1e-6) \
            if layernorm else None

    def reset_parameters(self, gen: torch.Generator | None) -> None:
        for lin in self.layers:
            init_linear_(lin, gen)

    def forward(self, h: torch.Tensor, adj: torch.Tensor,
                node_mask: torch.Tensor,
                seed_flag: torch.Tensor | None = None) -> torch.Tensor:
        n = adj.shape[1]
        eye = torch.eye(n, dtype=adj.dtype, device=adj.device)
        a_hat = adj + eye * node_mask[:, :, None]
        inv = torch.rsqrt(torch.clamp_min(a_hat.sum(dim=2), 1.0))
        a_norm = a_hat * inv[:, :, None] * inv[:, None, :]
        for lin in self.layers:
            h = torch.relu(aggregate_sum_dense(lin(h), a_norm))
        if self.readout == "root":
            if seed_flag is None:
                raise ValueError("the root readout needs the seed flag")
            out = torch.einsum("bnf,bn->bf", h, seed_flag)
        else:
            out = graph_pool_mean(h, node_mask)
        return self.norm(out) if self.norm is not None else out
