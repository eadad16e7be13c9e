"""InfoNCE losses (reference gcc/contrastive/criterions.py:5-33).

Inside a data-parallel step (``parallel/data_parallel.py``) a loss is
this rank's share of the global batch's mean — its rows' sum over the
global row count — so that the ranks' shares sum to the loss of the
global batch and their summed gradients to its gradient; E2E in-batch
negatives span the global batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gcc_tpu_torch.parallel import data_parallel


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the batch's rows; this rank's share of the global mean
    inside a data-parallel step."""
    dp = data_parallel.current()
    return x.mean() if dp is None else x.sum() / (x.numel() * dp.world)


def nce_softmax_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy. MoCo uses labels == 0 (positive in
    column 0); E2E uses diagonal labels."""
    if data_parallel.current() is None:
        return F.cross_entropy(logits, labels)
    return batch_mean(F.cross_entropy(logits, labels, reduction="none"))


def legacy_nce_probs(logits: torch.Tensor, n_data: int,
                     z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's legacy non-softmax NCE normalization
    (memory_moco.py:45-52): out = exp(logits) / Z, where ``logits`` are
    the already-temperature-scaled (B, 1+K) MoCo logits, ``n_data`` is
    the dataset size and ``z`` a device scalar: z < 0 means "estimate
    now" as Z = mean(exp) * n_data over the (global) batch (the
    reference sets it once, from the first batch, and freezes it; no
    gradient flows through it).

    Returns (probs, z_used). The reference then feeds these probabilities
    to the cross-entropy criterion as if they were logits; the train step
    reproduces that by composing with :func:`nce_softmax_loss`."""
    out = torch.exp(logits)
    mean = out.mean()
    dp = data_parallel.current()
    if dp is not None:
        mean = data_parallel.all_reduce_sum(
            out.detach().sum(), dp.group) / (out.numel() * dp.world)
    z_used = torch.where(z < 0, mean * n_data, z).detach()
    return out / z_used, z_used


def e2e_logits(feat_q: torch.Tensor, feat_k: torch.Tensor,
               temperature: float) -> torch.Tensor:
    """In-batch negatives: (B, B) logits feat_k @ feat_qᵀ / T with
    positives on the diagonal (reference train.py:396-401)."""
    return (feat_k @ feat_q.T) / temperature


def in_batch_loss(q_emb: torch.Tensor, k_emb: torch.Tensor,
                  temperature: float):
    """E2E InfoNCE over (B, B) in-batch logits, positives on the
    diagonal: (loss, mean positive logit). Inside a data-parallel step
    this rank's key rows meet the global batch's queries, all-gathered
    with their gradient (the rows' positives at rank·b + i)."""
    dp = data_parallel.current()
    if dp is None:
        logits = e2e_logits(q_emb, k_emb, temperature)
        labels = torch.arange(logits.shape[0], device=logits.device)
        return (nce_softmax_loss(logits, labels),
                torch.diagonal(logits).mean())
    q_all = data_parallel.all_gather(q_emb, dp.group)
    logits = e2e_logits(q_all, k_emb, temperature)
    b = k_emb.shape[0]
    labels = dp.rank * b + torch.arange(b, device=logits.device)
    return (nce_softmax_loss(logits, labels),
            batch_mean(logits.gather(1, labels[:, None])))
