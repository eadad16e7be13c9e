"""MPNN encoder (reference gcc/models/mpnn.py:13-99: lin0, then repeated
[NNConv edge-conditioned convolution → GRU] message passing).

Counterpart of ``gcc_tpu/models/mpnn.py``. The reference's encoder
passes no edge features to NNConv, so the edge network runs on a
constant scalar feature: every edge shares one (d, d) matrix W (the edge
network's (1, d·d) output read row-major), and a step is
GRU(ReLU(A @ (h W)), h).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gcc_tpu_torch.models.layers import init_linear_
from gcc_tpu_torch.ops.aggregate import aggregate_sum_dense


class GRUCell(nn.Module):
    """Flax's ``nn.GRUCell`` in torch's layout: gates stacked r, z, n in
    ``weight_ih`` (Flax's ``ir, iz, in`` kernels) and ``weight_hh``
    (``hr, hz, hn``); ``bias_ih`` holds the input biases of all three
    gates, ``bias_hn`` the one recurrent bias Flax has (``hn``'s). The
    r and z recurrent biases torch's kernel takes are zeros, not
    parameters."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.weight_ih = nn.Parameter(torch.empty(3 * hidden_size,
                                                  input_size))
        self.weight_hh = nn.Parameter(torch.empty(3 * hidden_size,
                                                  hidden_size))
        self.bias_ih = nn.Parameter(torch.empty(3 * hidden_size))
        self.bias_hn = nn.Parameter(torch.empty(hidden_size))
        self.reset_parameters()

    def reset_parameters(self, gen: torch.Generator | None = None) -> None:
        bound = 1.0 / math.sqrt(self.hidden_size)
        with torch.no_grad():
            for w in self.parameters():
                w.uniform_(-bound, bound, generator=gen)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        bias_hh = torch.cat([self.bias_hn.new_zeros(2 * self.hidden_size),
                             self.bias_hn])
        return torch.gru_cell(x, h, self.weight_ih, self.weight_hh,
                              self.bias_ih, bias_hh)


class UnsupervisedMPNN(nn.Module):
    def __init__(self, input_dim: int, node_hidden_dim: int = 64,
                 edge_hidden_dim: int = 64,
                 num_step_message_passing: int = 6):
        super().__init__()
        d = node_hidden_dim
        self.steps = num_step_message_passing
        self.lin0 = nn.Linear(input_dim, d)
        self.edge0 = nn.Linear(1, edge_hidden_dim)
        self.edge1 = nn.Linear(edge_hidden_dim, d * d)
        self.gru = GRUCell(d, d)

    def reset_parameters(self, gen: torch.Generator | None) -> None:
        for lin in (self.lin0, self.edge0, self.edge1):
            init_linear_(lin, gen)
        self.gru.reset_parameters(gen)

    def forward(self, h: torch.Tensor, adj: torch.Tensor,
                node_mask: torch.Tensor) -> torch.Tensor:
        b, n, _ = h.shape
        d = self.lin0.out_features
        out = torch.relu(self.lin0(h))
        e = h.new_ones((1, 1))
        w = self.edge1(torch.relu(self.edge0(e))).reshape(d, d)
        hidden = out.reshape(b * n, d)
        for _ in range(self.steps):
            m = torch.relu(aggregate_sum_dense(out @ w, adj)).reshape(b * n, d)
            hidden = self.gru(m, hidden)
            out = hidden.reshape(b, n, d)
        return out * node_mask[..., None]
