"""Learning-rate schedules (basicsr parity) as plain functions of the step.

Counterpart of ``latentsync_tpu/training/lr_schedules.py``
(ref:basicsr/models/lr_scheduler.py):

- MultiStepRestartLR (:9-40): milestone decay with optional restarts
  that reset the LR to base·restart_weight at given steps.
- CosineAnnealingRestartLR (:48-96): cosine annealing over consecutive
  periods, each restarting at base·restart_weight[i], floor eta_min.

Both are closed-form in the step index (no state). An optimizer applies one
as optax applies its schedule: the update after `n` earlier updates uses
``schedule(n)``, so the first uses ``schedule(0)``
(``option_trainer.scheduled``).
"""

from __future__ import annotations

import bisect
import math
from typing import Sequence


def multistep_restart_lr(base_lr: float, milestones: Sequence[int], gamma: float = 0.1,
                         restarts: Sequence[int] = (0,),
                         restart_weights: Sequence[float] = (1.0,)):
    """γ-decay at each milestone; at a restart step the decay count resets
    and the base is scaled by the restart weight (milestones are absolute
    steps, counted from the active restart on)."""
    if len(restarts) != len(restart_weights):
        raise ValueError("restarts and restart_weights must pair up")
    pairs = sorted(zip(restarts, restart_weights))
    starts = [r for r, _ in pairs]
    ms = sorted(milestones)

    def schedule(step: int) -> float:
        seg = min(max(bisect.bisect_right(starts, step) - 1, 0), len(pairs) - 1)
        start, weight = pairs[seg]
        passed = sum(1 for m in ms if start < m <= step)
        return base_lr * weight * gamma**passed

    return schedule


def cosine_annealing_restart_lr(base_lr: float, periods: Sequence[int],
                                restart_weights: Sequence[float] | None = None,
                                eta_min: float = 1e-7):
    """Cosine annealing through consecutive `periods`, each starting at
    base·weight[i] and annealing to eta_min."""
    if restart_weights is None:
        restart_weights = [1.0] * len(periods)
    if len(periods) != len(restart_weights):
        raise ValueError("periods and restart_weights must pair up")
    ends = [sum(periods[:i + 1]) for i in range(len(periods))]

    def schedule(step: int) -> float:
        idx = min(bisect.bisect_right(ends, step), len(periods) - 1)
        start = ends[idx] - periods[idx]
        frac = min(max((step - start) / max(periods[idx], 1), 0.0), 1.0)
        return eta_min + 0.5 * (base_lr * restart_weights[idx] - eta_min) * (
            1 + math.cos(math.pi * frac))

    return schedule


def warmup_wrap(schedule, warmup_steps: int, init_frac: float = 0.0):
    """Linear warmup in front of any schedule."""

    def wrapped(step: int) -> float:
        if warmup_steps <= 0:
            return schedule(step)
        return schedule(step) * (init_frac + (1.0 - init_frac) * min(step / warmup_steps, 1.0))

    return wrapped
