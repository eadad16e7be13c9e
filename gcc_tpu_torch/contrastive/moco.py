"""MoCo negative queue: a ring buffer of key embeddings on the device.

Counterpart of ``gcc_tpu/contrastive/moco.py`` (reference
gcc/contrastive/memory_moco.py:7-63). The port updates the queue in
place; JAX threads an immutable copy through its step.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class MoCoQueue:
    memory: torch.Tensor  # (K, dim) float32 — key embeddings (negatives)
    index: torch.Tensor   # () int64 — next write position (ring pointer)


def init_queue(k: int, dim: int, gen: torch.Generator | None,
               device="cuda") -> MoCoQueue:
    """U(-stdv, stdv) with stdv = 1/sqrt(dim/3) (memory_moco.py:20-23)."""
    stdv = 1.0 / math.sqrt(dim / 3.0)
    memory = torch.empty((k, dim), dtype=torch.float32, device=device)
    memory.uniform_(-stdv, stdv, generator=gen)
    return MoCoQueue(memory=memory,
                     index=torch.zeros((), dtype=torch.int64, device=device))


def moco_logits(queue: MoCoQueue, q: torch.Tensor, k: torch.Tensor,
                temperature: float) -> torch.Tensor:
    """(B, 1+K) logits: positive q·k first, then q·queue
    (memory_moco.py:33-44). k must carry no gradient."""
    l_pos = torch.sum(q * k, dim=-1, keepdim=True)
    l_neg = q @ queue.memory.T
    return torch.cat([l_pos, l_neg], dim=1) / temperature


@torch.no_grad()
def enqueue(queue: MoCoQueue, k: torch.Tensor) -> None:
    """Ring write of the batch's keys at [index, index+B) mod K
    (memory_moco.py:55-61), in place."""
    bsz = k.shape[0]
    kk = queue.memory.shape[0]
    ids = (queue.index + torch.arange(bsz, device=k.device)) % kk
    queue.memory.index_copy_(0, ids, k.detach())
    queue.index.copy_((queue.index + bsz) % kk)
