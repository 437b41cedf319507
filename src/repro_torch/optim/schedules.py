"""Learning-rate schedules, pure functions of the step counter
(counterpart of ``repro.optim.schedules``)."""
from __future__ import annotations

import math


def constant(lr: float):
    def sched(step):
        return float(lr)
    return sched


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int, *,
                  final_frac: float = 0.1):
    """Linear warm-up to ``peak_lr``, then a cosine down to
    ``final_frac * peak_lr`` at ``total_steps``."""
    def sched(step):
        step = float(step)
        if step < warmup_steps:
            return peak_lr * step / max(warmup_steps, 1)
        frac = min(max((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return peak_lr * (final_frac + (1 - final_frac)
                          * 0.5 * (1 + math.cos(math.pi * frac)))
    return sched
