"""Optimizer chain of the pretrain and finetune steps (reference
train.py:227-228, 409, 659-681).

Counterpart of ``gcc_tpu/training/optim.py``: clip (by global norm for
pre-training, by value for finetuning), then L2 weight decay into the
gradient (torch's ``weight_decay`` is that form, not decoupled AdamW),
then the optimizer (Adam, SGD with momentum, or Adagrad), then the
learning-rate schedule — the learning rate is set per step from the
schedule before ``optimizer.step()``.
"""

from __future__ import annotations

import torch

from gcc_tpu_torch.config import OptimConfig
from gcc_tpu_torch.parallel import data_parallel


class RSSAdagrad(torch.optim.Optimizer):
    """Adagrad as ``optax.scale_by_rss()`` computes it: the sum of squares
    starts at 0.1, and the update is g / sqrt(Σg² + 1e-7) (0 where Σg² is
    0). ``torch.optim.Adagrad`` starts its sum at 0 and adds eps outside
    the root; the two diverge from the first step. L2 decay enters the
    gradient first, as in the chain above."""

    INITIAL_SUM = 0.1
    EPS = 1e-7

    def __init__(self, params, lr: float, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                state = self.state[p]
                if not state:
                    state["sum"] = torch.full_like(p, self.INITIAL_SUM)
                total = state["sum"]
                total.add_(g * g)
                inv = torch.where(total > 0, torch.rsqrt(total + self.EPS),
                                  torch.zeros_like(total))
                p.sub_(group["lr"] * (inv * g))


def build_optimizer(params, cfg: OptimConfig) -> torch.optim.Optimizer:
    """The optimizer stage of the chain (decay included); clipping is
    :func:`clip_gradients_`, the rate ``lr_at`` per step."""
    params = list(params)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=cfg.learning_rate,
                                betas=(cfg.beta1, cfg.beta2), eps=1e-8,
                                weight_decay=cfg.weight_decay)
    if cfg.optimizer == "sgd":
        # optax.trace(decay=momentum): buf = momentum·buf + g from a zero
        # buffer — torch's SGD with dampening 0, no Nesterov.
        return torch.optim.SGD(params, lr=cfg.learning_rate,
                               momentum=cfg.momentum, dampening=0.0,
                               weight_decay=cfg.weight_decay)
    if cfg.optimizer == "adagrad":
        return RSSAdagrad(params, lr=cfg.learning_rate,
                          weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer: {cfg.optimizer}")


@torch.no_grad()
def clip_gradients_(params, cfg: OptimConfig,
                    clip_mode: str = "norm") -> torch.Tensor:
    """The chain's first stage, in place. "norm" (pre-training,
    clip_grad_norm 1.0): when the global norm ‖g‖ of all gradients
    reaches ``cfg.clip_norm`` > 0, scale each by clip_norm / ‖g‖
    (optax.clip_by_global_norm). "value" (finetuning, clip_grad_value_
    1): clamp every entry to [-1, 1] (optax.clip(1.0)). Returns ‖g‖
    before clipping, as a device scalar (no host synchronization).

    Inside a data-parallel step the gradients are first summed over the
    ranks (each rank's loss is its share of the global mean), so the clip
    sees the global norm and every rank takes the same update."""
    if clip_mode not in ("norm", "value"):
        raise ValueError(f"unknown clip_mode: {clip_mode}")
    params = list(params)
    data_parallel.all_reduce_grads_(params)
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.cat([g.reshape(-1) for g in grads]))
    if clip_mode == "value":
        for g in grads:
            g.clamp_(-1.0, 1.0)
    elif cfg.clip_norm > 0:
        # g / norm * clip_norm where the norm reaches the limit, g
        # (divided and multiplied by 1) elsewhere: two foreach launches.
        keep = norm < cfg.clip_norm
        torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
        torch._foreach_mul_(grads, torch.where(keep, 1.0, cfg.clip_norm))
    return norm
