"""InfoNCE loss (reference gcc/contrastive/criterions.py:5-33)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def nce_softmax_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy. MoCo uses labels == 0 (positive in
    column 0)."""
    return F.cross_entropy(logits, labels)
