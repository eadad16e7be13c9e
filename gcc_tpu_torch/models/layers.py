"""Shared model building blocks: masked BatchNorm and its
squeeze-and-excitation substitute, degree embedding, torch-default
initialization from an explicit generator.

Counterpart of ``gcc_tpu/models/layers.py``. Padded nodes must not
pollute batch statistics, so BatchNorm normalizes over real nodes only.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def init_linear_(layer: nn.Linear, gen: torch.Generator | None) -> None:
    """torch's nn.Linear default — U(±1/sqrt(fan_in)) for weight and bias
    (kaiming_uniform(a=sqrt(5))) — drawn from ``gen``."""
    bound = 1.0 / math.sqrt(layer.in_features)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=gen)
        if layer.bias is not None:
            layer.bias.uniform_(-bound, bound, generator=gen)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the flat node axis with padding masked out
    (``gcc_tpu/models/layers.py:75-126``).

    Train mode normalizes by the masked batch mean and biased variance
    and updates the running buffers as (1-m)·running + m·batch with
    m = 0.1, the variance unbiased by count/(count-1). Eval mode uses the
    running buffers. Input (..., N, F) with mask (..., N) of 1.0/0.0.
    """

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def eval_apply(self, x: torch.Tensor) -> torch.Tensor:
        """Normalization by the running buffers (eval mode; also the
        giant-graph path's, ``parallel/giant.py``)."""
        y = (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
        return y * self.weight + self.bias

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return self.eval_apply(x)
        dims = tuple(range(x.dim() - 1))
        m = mask[..., None]
        count = torch.clamp_min(mask.sum(), 1.0)
        mean = (x * m).sum(dim=dims) / count
        diff = (x - mean) * m
        var = (diff * diff).sum(dim=dims) / count
        with torch.no_grad():
            unbias = count / torch.clamp_min(count - 1.0, 1.0)
            self.running_mean.mul_(1 - self.momentum).add_(
                self.momentum * mean.detach())
            self.running_var.mul_(1 - self.momentum).add_(
                self.momentum * var.detach() * unbias)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias


class SELayer(nn.Module):
    """Squeeze-and-excitation reweighting, the reference's optional
    BatchNorm substitute (``gcc_tpu/models/gin.py:36-53``, reference
    gin.py:16-39): the mean over ALL real nodes of the whole batch, then
    Linear(c → max(1, ⌊√c⌋)), ELU, Linear(→ c), sigmoid, scaling every
    node's features. Same in train and eval mode; no buffers."""

    def __init__(self, channels: int):
        super().__init__()
        se = max(1, int(channels ** 0.5))
        self.linear0 = nn.Linear(channels, se)
        self.linear1 = nn.Linear(se, channels)

    def reset_parameters(self, gen: torch.Generator | None) -> None:
        init_linear_(self.linear0, gen)
        init_linear_(self.linear1, gen)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        dims = tuple(range(x.dim() - 1))
        count = torch.clamp_min(mask.sum(), 1.0)
        x_global = (x * mask[..., None]).sum(dim=dims) / count
        s = torch.sigmoid(self.linear1(nn.functional.elu(
            self.linear0(x_global))))
        return x * s


class DegreeEmbedding(nn.Module):
    """Degree-bucket embedding, N(0, 1) init, with the reference's
    clamp(deg, 0, max_degree) (graph_encoder.py:158-161)."""

    def __init__(self, max_degree: int, features: int):
        super().__init__()
        self.max_degree = max_degree
        self.embedding = nn.Embedding(max_degree + 1, features)

    def reset_parameters(self, gen: torch.Generator | None) -> None:
        with torch.no_grad():
            self.embedding.weight.normal_(0.0, 1.0, generator=gen)

    def forward(self, degrees: torch.Tensor) -> torch.Tensor:
        return self.embedding(torch.clamp(degrees, 0, self.max_degree).long())


def dropout(x: torch.Tensor, p: float, gen: torch.Generator | None,
            training: bool) -> torch.Tensor:
    """Inverted dropout drawing its mask from ``gen``."""
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
    return x * keep / (1.0 - p)
