"""Learning-rate schedules of the two trainers — the optax formulas that
``dgdm_tpu/train/dynamics.py:52-60`` and ``generator.py:55-61`` build
(``optax.cosine_decay_schedule`` and ``warmup_cosine_decay_schedule``),
evaluated at optax's count: the number of updates already applied, so the
first update uses the schedule at 0. optax evaluates them in float32, and so
do these (a warmup's ``(0 - lr) * (1 - c / w) + lr`` differs from
``lr * c / w`` by far more than float32's rounding at small counts).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

_F = np.float32


def cosine_lr(learning_rate: float, total_steps: int, warmup_steps: int = 0,
              end_value: float = 0.0) -> Callable[[int], float]:
    """count -> learning rate: cosine decay from ``learning_rate`` to
    ``end_value`` over ``max(total_steps, 1)`` updates, after a linear
    warmup from 0 over ``warmup_steps`` when that is > 0 (the decay then
    spans the remaining updates, as optax's does)."""
    total = max(total_steps, 1)
    alpha = 0.0 if learning_rate == 0.0 else end_value / learning_rate

    def cosine(count: int, decay_steps: int) -> float:
        c = np.minimum(_F(count), _F(decay_steps))
        decay = _F(0.5) * (_F(1) + np.cos(_F(np.pi) * c / _F(decay_steps)))
        return float(_F(learning_rate) * (_F(1 - alpha) * decay + _F(alpha)))

    if warmup_steps <= 0:
        return lambda count: cosine(count, total)
    if total - warmup_steps <= 0:
        raise ValueError("the cosine decay after the warmup needs positive "
                         f"steps, got total {total} <= warmup "
                         f"{warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = _F(1) - _F(min(max(count, 0), warmup_steps)) \
                / _F(warmup_steps)
            return float(_F(-learning_rate) * frac + _F(learning_rate))
        return cosine(count - warmup_steps, total - warmup_steps)

    return schedule


def adam(params, learning_rate: float, schedule: Callable[[int], float],
         betas=(0.9, 0.999), weight_decay: float = 0.0):
    """``torch.optim.Adam`` (eps 1e-8; ``weight_decay`` added to the
    gradient before the moments, as ``optax.add_decayed_weights`` ahead of
    ``scale_by_adam`` does; not AdamW) and a ``LambdaLR`` that sets each
    update's rate to ``schedule(count)``."""
    opt = torch.optim.Adam(params, lr=learning_rate, betas=betas, eps=1e-8,
                           weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: schedule(count) / learning_rate)
    return opt, sched
