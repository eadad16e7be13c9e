"""InfoNCE losses (reference gcc/contrastive/criterions.py:5-33)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def nce_softmax_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy. MoCo uses labels == 0 (positive in
    column 0); E2E uses diagonal labels."""
    return F.cross_entropy(logits, labels)


def legacy_nce_probs(logits: torch.Tensor, n_data: int,
                     z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's legacy non-softmax NCE normalization
    (memory_moco.py:45-52): out = exp(logits) / Z, where ``logits`` are
    the already-temperature-scaled (B, 1+K) MoCo logits, ``n_data`` is
    the dataset size and ``z`` a device scalar: z < 0 means "estimate
    now" as Z = mean(exp) * n_data (the reference sets it once, from the
    first batch, and freezes it; no gradient flows through it).

    Returns (probs, z_used). The reference then feeds these probabilities
    to the cross-entropy criterion as if they were logits; the train step
    reproduces that by composing with :func:`nce_softmax_loss`."""
    out = torch.exp(logits)
    z_used = torch.where(z < 0, out.mean() * n_data, z).detach()
    return out / z_used, z_used


def e2e_logits(feat_q: torch.Tensor, feat_k: torch.Tensor,
               temperature: float) -> torch.Tensor:
    """In-batch negatives: (B, B) logits feat_k @ feat_qᵀ / T with
    positives on the diagonal (reference train.py:396-401)."""
    return (feat_k @ feat_q.T) / temperature
