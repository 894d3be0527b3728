"""LR schedules: step -> learning rate, as the reference's LambdaLR
multipliers applied to a base rate.

Counterpart of ``showo_tpu/training/lr_schedules.py`` (constant,
constant_with_warmup, linear, cosine, cosine_with_restarts, polynomial),
on Python floats.  The trainer evaluates the schedule at the number of
optimizer steps taken so far, as optax evaluates its schedules at the
update count.
"""

from __future__ import annotations

import math
from typing import Callable


def get_lr_schedule(
    name: str,
    base_lr: float,
    num_warmup_steps: int = 0,
    num_training_steps: int = 0,
    num_cycles: float = 0.5,
    power: float = 1.0,
    lr_end: float = 1e-7,
) -> Callable[[int], float]:
    warmup = max(1, num_warmup_steps)
    decay_steps = max(1, num_training_steps - num_warmup_steps)

    def ramp(step):
        return min(step / warmup, 1.0)

    def progress(step):
        return (step - num_warmup_steps) / decay_steps

    if name == "constant":
        return lambda step: float(base_lr)
    if name == "constant_with_warmup":
        return lambda step: base_lr * ramp(step)
    if name == "linear":
        return lambda step: base_lr * (
            ramp(step) if step < num_warmup_steps else
            min(max((num_training_steps - step) / decay_steps, 0.0), 1.0))
    if name == "cosine":
        # progress is not clipped at 1: the reference keeps evaluating the
        # cosine past num_training_steps
        return lambda step: base_lr * (
            ramp(step) if step < num_warmup_steps else max(0.0, 0.5 * (
                1.0 + math.cos(math.pi * num_cycles * 2.0 * progress(step)))))

    if name == "cosine_with_restarts":
        def restarts(step):
            prog = min(max(progress(step), 0.0), 1.0)
            if prog >= 1.0:
                return 0.0
            return max(0.0, 0.5 * (1.0 + math.cos(
                math.pi * ((num_cycles * prog) % 1.0))))
        return lambda step: base_lr * (
            ramp(step) if step < num_warmup_steps else restarts(step))

    if name == "polynomial":
        def poly(step):
            if step < num_warmup_steps:
                return base_lr * ramp(step)
            if step > num_training_steps:
                return lr_end
            rem = min(max(1 - progress(step), 0.0), 1.0)
            return (base_lr - lr_end) * rem ** power + lr_end
        return poly

    raise ValueError(f"unknown schedule {name}")
