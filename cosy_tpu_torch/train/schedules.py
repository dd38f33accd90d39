"""Learning-rate schedules as plain functions step -> lr (the port of the
JAX package's ``train/schedules.py``).

- ``warmup_cosine``: the fine-tune schedule: linear warmup, then cosine
  down to the min_lr / base_lr floor.
- ``warmup_lr``: the vendored Noam-style WarmupLR,
  lr * warmup^0.5 * min(step^-0.5, step * warmup^-1.5).
- the NeMo-style annealing policies of the vendored trainer.

``step`` is the 0-based count of optimizer updates already made.
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def warmup_cosine(base_lr: float, min_lr: float, warmup_steps: int,
                  total_steps: int) -> Schedule:
    def schedule(step):
        if step < warmup_steps:
            return base_lr * step / max(1, warmup_steps)
        progress = (step - warmup_steps) / max(1, total_steps - warmup_steps)
        cos = 0.5 * (1.0 + math.cos(progress * 3.14159))  # truncated pi per reference
        return base_lr * max(min_lr / base_lr, cos)

    return schedule


def warmup_lr(base_lr: float, warmup_steps: int = 25000) -> Schedule:
    """``step_num = last_epoch + 1``: a 0-based step maps to s = step + 1."""

    def schedule(step):
        s = step + 1.0
        if warmup_steps == 0:
            return base_lr * s ** -0.5
        return base_lr * warmup_steps ** 0.5 * min(s ** -0.5, s * warmup_steps ** -1.5)

    return schedule


def constant_lr(base_lr: float) -> Schedule:
    return lambda step: base_lr


def _warmup_policy(base_lr: float, warmup_steps: int, max_steps: int,
                   min_lr: float, anneal) -> Schedule:
    """NeMo WarmupPolicy.get_lr: ``step <= warmup`` -> base * (step + 1) /
    (warmup + 1); ``step > max_steps`` -> min_lr; else the annealing function."""

    def schedule(step):
        if warmup_steps > 0 and step <= warmup_steps:
            return base_lr * (step + 1.0) / (warmup_steps + 1.0)
        return min_lr if step > max_steps else anneal(float(step))

    return schedule


def square_annealing(base_lr: float, warmup_steps: int, max_steps: int,
                     min_lr: float = 0.0) -> Schedule:
    """The anneal runs on (step - warmup) over (max_steps - warmup), so the
    curve starts at base_lr exactly when warmup ends."""
    span = max(max_steps - warmup_steps, 1)
    return _warmup_policy(base_lr, warmup_steps, max_steps, min_lr, lambda s: max(
        base_lr * ((span - (s - warmup_steps)) / span) ** 2, min_lr))


def squareroot_annealing(base_lr: float, warmup_steps: int, max_steps: int,
                         min_lr: float = 0.0) -> Schedule:
    return _warmup_policy(base_lr, warmup_steps, max_steps, min_lr, lambda s: max(
        base_lr * math.sqrt(max((max_steps - s) / max_steps, 0.0)), min_lr))


def cosine_annealing(base_lr: float, warmup_steps: int, max_steps: int,
                     min_lr: float = 0.0) -> Schedule:
    """Like square_annealing, the anneal phase is offset by warmup_steps
    (squareroot_annealing is not, per the reference)."""
    span = max(max_steps - warmup_steps, 1)
    return _warmup_policy(base_lr, warmup_steps, max_steps, min_lr, lambda s: (
        base_lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi * (s - warmup_steps) / span))
        + min_lr)


def noam_annealing(base_lr: float, d_model: int, warmup_steps: int,
                   min_lr: float = 0.0) -> Schedule:
    """``step = max(1, last_epoch)``."""
    normalize = d_model ** -0.5

    def schedule(step):
        s = max(float(step), 1.0)
        if warmup_steps > 0:
            mult = normalize * min(s ** -0.5, s * warmup_steps ** -1.5)
        else:
            mult = normalize * s ** -0.5
        lr = base_lr * mult
        return max(lr, min_lr) if s > warmup_steps else lr

    return schedule


def noam_hold_annealing(base_lr: float, warmup_steps: int, hold_steps: int,
                        max_steps: int, decay_rate: float = 0.5,
                        min_lr: float = 0.0) -> Schedule:
    """Linear warmup -> hold at the peak until ``warmup + hold`` ->
    polynomial decay ``base * warmup^dr / (step - hold)^dr``.  ``hold_steps``
    is the hold's duration, not its absolute end."""
    hold_end = hold_steps + warmup_steps

    def schedule(step):
        s = float(step)
        if warmup_steps > 0 and s <= warmup_steps:
            return base_lr * (s + 1.0) / (warmup_steps + 1.0)
        if warmup_steps <= s < hold_end:
            return base_lr
        if s > max_steps:
            return min_lr
        t_warm = max(1.0, warmup_steps ** decay_rate)
        d = s - hold_steps
        t_hold = max(1.0, math.copysign(abs(d) ** decay_rate, d) if d else 0.0)
        return max(base_lr * t_warm / t_hold, min_lr)

    return schedule


SCHEDULES = {
    "warmuplr": warmup_lr,
    "warmup_cosine": warmup_cosine,
    "constantlr": constant_lr,
    "cosine_annealing": cosine_annealing,
    "square_annealing": square_annealing,
    "squareroot_annealing": squareroot_annealing,
    "noam_annealing": noam_annealing,
    "noamhold_annealing": noam_hold_annealing,
}


def make_schedule(train_cfg, total_steps: int) -> Schedule:
    """The schedule selected by ``TrainConfig.scheduler``."""
    name = train_cfg.scheduler.lower()
    lr, min_lr, warm = (train_cfg.learning_rate, train_cfg.min_learning_rate,
                        train_cfg.warmup_steps)
    if name == "warmup_cosine":
        return warmup_cosine(lr, min_lr, warm, total_steps)
    if name == "warmuplr":
        return warmup_lr(lr, warm)
    if name == "constantlr":
        return constant_lr(lr)
    if name == "cosine_annealing":
        return cosine_annealing(lr, warm, total_steps, min_lr)
    if name == "square_annealing":
        return square_annealing(lr, warm, total_steps, min_lr)
    if name == "squareroot_annealing":
        return squareroot_annealing(lr, warm, total_steps, min_lr)
    if name == "noam_annealing":
        return noam_annealing(lr, train_cfg.scheduler_d_model, warm, min_lr)
    if name == "noamhold_annealing":
        return noam_hold_annealing(lr, warm, train_cfg.scheduler_hold_steps, total_steps,
                                   train_cfg.scheduler_decay_rate, min_lr)
    raise ValueError(f"unknown scheduler {train_cfg.scheduler!r}; "
                     f"one of {sorted(SCHEDULES)}")
