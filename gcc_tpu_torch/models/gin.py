"""Graph Isomorphism Network encoder (the reference's default model).

Counterpart of ``gcc_tpu/models/gin.py`` (reference
gcc/models/gin.py:119-232 with learn_eps=False, sum aggregation, sum
pooling, 2-layer MLPs). Per conv layer (num_layers - 1 of them):

    agg = h + Σ_{u∈N(v)} h_u                    (GINConv, ε=0)
    z   = Linear_2(ReLU(BN_mlp(Linear_1(agg)))) (GINMLP)
    z   = ReLU(BN_apply(z))                     (ApplyNodeFunc)
    h   = ReLU(BN_outer(z))                     (UnsupervisedGIN loop)

readout: score = Σ_i Dropout(Linear_pred_i(sum_pool(h_i))) over
[input, h_1, .., h_{L-1}]; the pooled list is returned beside the score.
Aggregation is one batched matmul on the dense adjacency per layer.
With ``use_selayer`` every BN above is an :class:`SELayer` instead.
"""

from __future__ import annotations

import torch
from torch import nn

from gcc_tpu_torch.models.layers import (
    MaskedBatchNorm,
    SELayer,
    dropout,
    init_linear_,
)
from gcc_tpu_torch.ops.aggregate import aggregate_sum_dense, graph_pool_sum


def _norm(channels: int, use_selayer: bool) -> nn.Module:
    return SELayer(channels) if use_selayer else MaskedBatchNorm(channels)


def _reset_norm(norm: nn.Module, gen: torch.Generator | None) -> None:
    if isinstance(norm, SELayer):
        norm.reset_parameters(gen)


class GINMLP(nn.Module):
    """2-layer MLP with BN (or SE) + ReLU on the hidden layer."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int,
                 use_selayer: bool = False):
        super().__init__()
        self.linear0 = nn.Linear(in_dim, hidden_dim)
        self.bn = _norm(hidden_dim, use_selayer)
        self.linear1 = nn.Linear(hidden_dim, output_dim)

    def reset_parameters(self, gen: torch.Generator | None) -> None:
        init_linear_(self.linear0, gen)
        _reset_norm(self.bn, gen)
        init_linear_(self.linear1, gen)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.bn(self.linear0(x), mask))
        return self.linear1(h)


class UnsupervisedGIN(nn.Module):
    def __init__(self, input_dim: int, num_layers: int = 5,
                 hidden_dim: int = 64, output_dim: int = 64,
                 final_dropout: float = 0.5, use_selayer: bool = False):
        super().__init__()
        self.final_dropout = final_dropout
        dims = [input_dim] + [hidden_dim] * (num_layers - 1)
        self.mlps = nn.ModuleList(
            GINMLP(dims[i], hidden_dim, hidden_dim, use_selayer)
            for i in range(num_layers - 1))
        # Two norms per layer: ApplyNodeFunc's, then the outer loop's.
        self.norms = nn.ModuleList(
            _norm(hidden_dim, use_selayer)
            for _ in range(2 * (num_layers - 1)))
        self.readouts = nn.ModuleList(
            nn.Linear(d, output_dim) for d in dims)

    def reset_parameters(self, gen: torch.Generator | None) -> None:
        for i, mlp in enumerate(self.mlps):
            mlp.reset_parameters(gen)
            _reset_norm(self.norms[2 * i], gen)
            _reset_norm(self.norms[2 * i + 1], gen)
        for lin in self.readouts:
            init_linear_(lin, gen)

    def forward(self, h: torch.Tensor, adj: torch.Tensor,
                node_mask: torch.Tensor, gen: torch.Generator | None = None):
        """h (B, N, F_in), adj (B, N, N), node_mask (B, N) → (score
        (B, output_dim), pooled list: (B, F_in) input then (B, hidden)
        per conv layer)."""
        hidden_rep = [h]
        for i, mlp in enumerate(self.mlps):
            agg = h + aggregate_sum_dense(h, adj)
            z = mlp(agg, node_mask)
            z = torch.relu(self.norms[2 * i](z, node_mask))
            h = torch.relu(self.norms[2 * i + 1](z, node_mask))
            hidden_rep.append(h)
        score = 0.0
        pooled_all = []
        for rep, lin in zip(hidden_rep, self.readouts):
            pooled = graph_pool_sum(rep, node_mask)
            pooled_all.append(pooled)
            score = score + dropout(lin(pooled), self.final_dropout, gen,
                                    self.training)
        return score, pooled_all
