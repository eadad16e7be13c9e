"""Set2Set readout of the alternate encoders (reference: DGL Set2Set,
graph_encoder.py:124,192-194).

Counterpart of ``gcc_tpu/models/set2set.py``: an LSTM-driven attention
pooling run for ``num_iters`` steps through ``num_layers`` stacked cells,
returning [q, Σ softmax(<h, q>) h] of width 2·hidden; the softmax is
masked, so padded nodes get zero attention.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class LSTMCell(nn.Module):
    """Flax's ``nn.LSTMCell`` in torch's layout: gates stacked i, f, g, o
    in ``weight_ih`` (Flax's per-gate ``ii … io`` kernels) and
    ``weight_hh`` (``hi … ho``), the recurrent biases in ``bias_hh``.
    Flax's input kernels have no bias, and neither has this cell."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden_size,
                                                  input_size))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden_size,
                                                  hidden_size))
        self.bias_hh = nn.Parameter(torch.empty(4 * hidden_size))
        self.reset_parameters()

    def reset_parameters(self, gen: torch.Generator | None = None) -> None:
        bound = 1.0 / math.sqrt(self.hidden_size)
        with torch.no_grad():
            for w in self.parameters():
                w.uniform_(-bound, bound, generator=gen)

    def forward(self, x: torch.Tensor, carry):
        """carry (c, h) → ((c', h'), h'), Flax's call convention."""
        c, h = carry
        h2, c2 = torch.lstm_cell(x, (h, c), self.weight_ih, self.weight_hh,
                                 None, self.bias_hh)
        return (c2, h2), h2


class Set2Set(nn.Module):
    def __init__(self, hidden_dim: int, num_iters: int = 6,
                 num_layers: int = 3):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_iters = num_iters
        self.lstms = nn.ModuleList(
            LSTMCell(2 * hidden_dim if i == 0 else hidden_dim, hidden_dim)
            for i in range(num_layers))

    def reset_parameters(self, gen: torch.Generator | None) -> None:
        for cell in self.lstms:
            cell.reset_parameters(gen)

    def forward(self, h: torch.Tensor, node_mask: torch.Tensor
                ) -> torch.Tensor:
        """h (B, N, F), node_mask (B, N) → (B, 2F)."""
        b = h.shape[0]
        zeros = h.new_zeros((b, self.hidden_dim))
        carries = [(zeros, zeros) for _ in self.lstms]
        q_star = h.new_zeros((b, 2 * self.hidden_dim))
        for _ in range(self.num_iters):
            x = q_star
            for i, cell in enumerate(self.lstms):
                carries[i], x = cell(x, carries[i])
            scores = torch.einsum("bnf,bf->bn", h, x)
            scores = torch.where(node_mask > 0, scores,
                                 torch.full_like(scores, -1e30))
            alpha = torch.softmax(scores, dim=-1) * node_mask
            alpha = alpha / torch.clamp_min(alpha.sum(-1, keepdim=True),
                                            1e-12)
            r = torch.einsum("bn,bnf->bf", alpha, h)
            q_star = torch.cat([x, r], dim=-1)
        return q_star
