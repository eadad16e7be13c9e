"""Optimizer chain of the pretrain step (reference train.py:659-681).

Counterpart of ``gcc_tpu/training/optim.py``: clip-by-global-norm, then
L2 weight decay into the gradient (torch Adam's ``weight_decay`` is that
form, not decoupled AdamW), then Adam, then the learning-rate schedule —
the learning rate is set per step from the schedule before
``optimizer.step()``.
"""

from __future__ import annotations

import torch

from gcc_tpu_torch.config import OptimConfig


def build_optimizer(params, cfg: OptimConfig) -> torch.optim.Adam:
    if cfg.optimizer != "adam":
        raise NotImplementedError(f"optimizer {cfg.optimizer!r} is not "
                                  "ported yet; only 'adam' is")
    return torch.optim.Adam(params, lr=cfg.learning_rate,
                            betas=(cfg.beta1, cfg.beta2), eps=1e-8,
                            weight_decay=cfg.weight_decay)


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """Scale every gradient by max_norm / ‖g‖ when the global norm ‖g‖
    of all of them reaches max_norm (optax.clip_by_global_norm: g / ‖g‖
    · max_norm). Returns ‖g‖ before clipping, as a device scalar (no host
    synchronization)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.cat([g.reshape(-1) for g in grads]))
    if max_norm > 0:
        keep = norm < max_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm
