"""Linear warm-up from 0 over ``warmup_steps`` updates, then a cosine from
``lr`` down to ``lr_final`` over the remaining ``num_steps`` (optax's
``join_schedules`` of ``linear_schedule`` and ``cosine_decay_schedule``);
``count`` is the number of updates done before this one."""

import math


def lr(train_cfg: dict, count: int) -> float:
    base, warm = train_cfg["lr"], train_cfg["warmup_steps"]
    if count < warm:
        return base * min(max(count, 0), warm) / warm
    decay_steps = max(train_cfg["num_steps"] - warm, 1)
    alpha = train_cfg["lr_final"] / base if base else 0.0
    c = min(count - warm, decay_steps)
    decay = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
    return base * ((1.0 - alpha) * decay + alpha)
