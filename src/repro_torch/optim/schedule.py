"""Learning-rate schedules, copied from ``repro/optim/schedule.py`` (plain
Python).  The paper uses step decay at round 4000 (Tab 13)."""
from __future__ import annotations

import math


def constant(lr: float):
    return lambda step: lr


def step_decay(lr: float, boundary: int, factor: float = 0.1):
    """Paper Table 13: 0.1 for r <= 4000 then 0.01."""
    return lambda step: lr * (factor if step > boundary else 1.0)


def warmup_cosine(lr: float, warmup: int, total: int, floor: float = 0.0):
    def f(step):
        if step < warmup:
            return lr * (step + 1) / warmup
        frac = (step - warmup) / max(total - warmup, 1)
        return floor + 0.5 * (lr - floor) * (1 + math.cos(math.pi * min(frac, 1.0)))
    return f
