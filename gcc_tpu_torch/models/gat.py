"""Graph attention encoder (reference gcc/models/gat.py:15-41: DGL-chem
GATLayer × num_layers, 4 heads flattened, leaky-ReLU between layers, no
dropout, no residual, negative slope 0.2).

Counterpart of ``gcc_tpu/models/gat.py``: attention runs densely over
the batched adjacency — scores for all node pairs, masked to existing
edges. A multigraph's t parallel edges contribute t identical terms to
the edge softmax, so log(multiplicity) is added to the score; masked
scores are −1e30 and their weights are set back to 0.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gcc_tpu_torch.models.layers import init_linear_


class GATLayer(nn.Module):
    def __init__(self, in_dim: int, out_per_head: int, num_heads: int,
                 negative_slope: float = 0.2):
        super().__init__()
        self.num_heads = num_heads
        self.out_per_head = out_per_head
        self.negative_slope = negative_slope
        self.fc = nn.Linear(in_dim, num_heads * out_per_head, bias=False)
        self.attn_l = nn.Parameter(torch.empty(num_heads, out_per_head))
        self.attn_r = nn.Parameter(torch.empty(num_heads, out_per_head))

    def reset_parameters(self, gen: torch.Generator | None) -> None:
        init_linear_(self.fc, gen)
        # Flax's variance_scaling(1/3, fan_in, uniform) on (heads, F):
        # fan_in is the head count.
        bound = 1.0 / math.sqrt(self.num_heads)
        with torch.no_grad():
            self.attn_l.uniform_(-bound, bound, generator=gen)
            self.attn_r.uniform_(-bound, bound, generator=gen)

    def forward(self, h: torch.Tensor, adj: torch.Tensor,
                node_mask: torch.Tensor) -> torch.Tensor:
        """h (B, N, F); adj (B, N, N) with A[v, u] > 0 iff edge u → v."""
        b, n, _ = h.shape
        z = self.fc(h).reshape(b, n, self.num_heads, self.out_per_head)
        el = torch.einsum("bnhf,hf->bnh", z, self.attn_l)   # destination
        er = torch.einsum("bnhf,hf->bnh", z, self.attn_r)   # source
        # scores[b, h, v, u] for edge u → v.
        scores = (el.permute(0, 2, 1)[:, :, :, None]
                  + er.permute(0, 2, 1)[:, :, None, :])
        scores = nn.functional.leaky_relu(scores, self.negative_slope)
        edge = adj > 0
        log_mult = torch.where(edge, torch.log(torch.clamp_min(adj, 1e-12)),
                               torch.zeros_like(adj))
        mask = edge[:, None, :, :]
        scores = torch.where(mask, scores + log_mult[:, None, :, :],
                             torch.full_like(scores, -1e30))
        alpha = torch.softmax(scores, dim=-1)
        alpha = torch.where(mask, alpha, torch.zeros_like(alpha))
        out = torch.einsum("bhvu,buhf->bvhf", alpha, z)
        out = out.reshape(b, n, self.num_heads * self.out_per_head)
        return out * node_mask[..., None]


class UnsupervisedGAT(nn.Module):
    def __init__(self, input_dim: int, node_hidden_dim: int = 64,
                 num_layers: int = 5, num_heads: int = 4):
        super().__init__()
        if node_hidden_dim % num_heads:
            raise ValueError(f"hidden size {node_hidden_dim} is no multiple "
                             f"of {num_heads} heads")
        per_head = node_hidden_dim // num_heads
        self.layers = nn.ModuleList(
            GATLayer(input_dim if i == 0 else node_hidden_dim, per_head,
                     num_heads) for i in range(num_layers))

    def reset_parameters(self, gen: torch.Generator | None) -> None:
        for layer in self.layers:
            layer.reset_parameters(gen)

    def forward(self, h: torch.Tensor, adj: torch.Tensor,
                node_mask: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            h = layer(h, adj, node_mask)
            if i + 1 < len(self.layers):
                h = nn.functional.leaky_relu(h, 0.2)
        return h
