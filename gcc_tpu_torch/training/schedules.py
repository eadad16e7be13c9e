"""LR schedules (reference gcc/utils/misc.py:5-20)."""

from __future__ import annotations


def warmup_linear(progress: float, warmup: float = 0.1) -> float:
    """Triangular schedule: linear 0→1 over the first `warmup` fraction of
    training, then linear 1→0 (reference warmup_linear, used at
    train.py:412-414 with warmup=0.1)."""
    if progress < warmup:
        return progress / warmup
    return max((progress - 1.0) / (warmup - 1.0), 0.0)


def lr_at(step: int, base_lr: float, total_steps: int,
          warmup: float = 0.1) -> float:
    """Learning rate of optimizer update number ``step`` (0-based, like
    optax's schedule count: the first update runs at lr 0)."""
    return base_lr * warmup_linear(step / total_steps, warmup)
