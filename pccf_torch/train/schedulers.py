"""Learning-rate schedules (``pccf/train/schedulers.py``): pure functions of
the epoch, composed with restarts and a warmup ramp."""

from __future__ import annotations

import math
from typing import Callable

from pccf_torch.config import SchedulerConfig

Schedule = Callable[[float], float]


def cosine_scheduler(min_decay: float = 0.01, decay_steps: int = 100) -> Schedule:
    """Cosine decay from 1 to ``min_decay`` over ``decay_steps`` epochs."""

    def f(epoch: float) -> float:
        t = min(epoch, decay_steps) / max(decay_steps, 1)
        return min_decay + (1.0 - min_decay) * 0.5 * (1.0 + math.cos(math.pi * t))

    return f


def restart(base: Schedule, restart_interval: int, restart_fraction: float = 1.0) -> Schedule:
    """Restart ``base`` every ``restart_interval`` epochs, the amplitude
    scaled by ``restart_fraction`` at each restart."""
    if restart_interval <= 0:
        return base

    def f(epoch: float) -> float:
        k = int(epoch // restart_interval)
        return (restart_fraction**k) * base(epoch - k * restart_interval)

    return f


def warmup(base: Schedule, warmup_steps: int) -> Schedule:
    """Linear ramp over the first ``warmup_steps`` epochs."""
    if warmup_steps <= 0:
        return base
    return lambda epoch: min(1.0, (epoch + 1.0) / warmup_steps) * base(epoch)


def get_scheduler(cfg: SchedulerConfig) -> Schedule:
    """``cfg.function``'s base schedule (the flagship's cosine, constant or
    exponential) with restarts and warmup (``schedulers.py`` ``get_scheduler``)."""
    if cfg.function == 'Cosine':
        base = cosine_scheduler(cfg.min_decay, cfg.decay_steps)
    elif cfg.function == 'Constant':
        base = lambda epoch: 1.0  # noqa: E731
    elif cfg.function == 'Exponential':
        base = lambda epoch: cfg.exp_decay**epoch  # noqa: E731
    else:
        raise ValueError(f'Scheduler {cfg.function} not supported.')
    return warmup(restart(base, cfg.restart_interval, cfg.restart_fraction), cfg.warmup_steps)
