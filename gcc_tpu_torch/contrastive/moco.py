"""MoCo negative queue: a ring buffer of key embeddings on the device.

Counterpart of ``gcc_tpu/contrastive/moco.py`` (reference
gcc/contrastive/memory_moco.py:7-63). The port updates the queue in
place; JAX threads an immutable copy through its step.

Under data parallelism (``parallel/data_parallel.py``) the keys that go
into the queue are the global batch's, in (device, graph) order. The
queue is replicated (every rank writes all of them), or row-sharded
over ``shards`` ranks (each holds K/shards consecutive rows and writes
the keys that land there; the logits gather all K rows).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gcc_tpu_torch.parallel import data_parallel


@dataclasses.dataclass
class MoCoQueue:
    memory: torch.Tensor  # (K, dim) float32 — key embeddings (negatives)
    index: torch.Tensor   # () int64 — next write position (ring pointer)
    # Ranks the rows are sharded over: memory then holds this rank's
    # K / shards rows (data_parallel.shard_state).
    shards: int = 1


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
    memory = queue.memory
    if queue.shards > 1:
        memory = data_parallel.all_gather(memory,
                                          data_parallel.current().group)
    l_neg = q @ memory.T
    return torch.cat([l_pos, l_neg], dim=1) / temperature


@torch.no_grad()
def enqueue(queue: MoCoQueue, k: torch.Tensor) -> None:
    """Ring write of the batch's keys at [index, index+B) mod K
    (memory_moco.py:55-61), in place. Inside a data-parallel step the
    keys are all-gathered first: B is the global batch."""
    dp = data_parallel.current()
    if dp is not None:
        k = data_parallel.all_gather(k.detach(), dp.group)
    bsz = k.shape[0]
    rows = queue.memory.shape[0]
    kk = rows * queue.shards
    ids = (queue.index + torch.arange(bsz, device=k.device)) % kk
    if queue.shards > 1:
        # This rank's rows are [rank·rows, (rank + 1)·rows).
        local = ids - dp.rank * rows
        own = (local >= 0) & (local < rows)
        queue.memory.index_copy_(0, local[own], k.detach()[own])
    else:
        queue.memory.index_copy_(0, ids, k.detach())
    queue.index.copy_((queue.index + bsz) % kk)
