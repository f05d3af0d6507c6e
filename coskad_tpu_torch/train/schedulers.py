"""Learning-rate schedules as epoch -> lr callables.

The port's own copy of `coskad_tpu/train/schedulers.py` (a module with no
JAX in it; the port imports nothing of the JAX package). The reference carries several schedulers (utils/model_utils.py:11-88 and the
Lightning configure_optimizers blocks): constant-effective cosine (the
CosineAnnealingLR with eta_min == base lr quirk, euclidean_encoder_
staticCenter.py:222-225), ReduceLROnPlateau on validation AUC (handled on the
host in train/loop.py), StepLR, triangular2 cyclic ('tri'), exponential
decay, and a delayed-start wrapper (DelayerScheduler). All are pure
step -> lr functions; the Trainer sets the optimizer's lr from them at the
start of each epoch.
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def constant(lr: float) -> Schedule:
    return lambda step: lr


def cosine_annealing(lr: float, t_max: int, eta_min: float = 0.0) -> Schedule:
    """torch CosineAnnealingLR semantics. Note: the reference passes
    eta_min == lr, which degenerates to a constant schedule — preserved when
    callers do the same."""

    def fn(step: int) -> float:
        t = min(step, t_max)
        return eta_min + (lr - eta_min) * (1 + math.cos(math.pi * t / t_max)) / 2

    return fn


def step_decay(lr: float, step_size: int = 5, gamma: float = 0.99) -> Schedule:
    return lambda step: lr * gamma ** (step // step_size)


def exponential(lr: float, decay: float = 0.99) -> Schedule:
    """The reference's adjust_lr fallback: lr * decay^epoch
    (utils/model_utils.py:79-88)."""
    return lambda step: lr * decay**step


def triangular2(
    base_lr: float, max_lr: float, step_size_up: int
) -> Schedule:
    """torch CyclicLR(mode='triangular2') semantics: triangle wave between
    base and max, halving the amplitude each full cycle (the reference's
    'tri' scheduler with base lr/10, max lr*10, step epochs//8)."""

    def fn(step: int) -> float:
        cycle = math.floor(1 + step / (2 * step_size_up))
        x = abs(step / step_size_up - 2 * cycle + 1)
        scale = 1.0 / (2 ** (cycle - 1))
        return base_lr + (max_lr - base_lr) * max(0.0, 1 - x) * scale

    return fn


def tri_from_config(lr: float, epochs: int) -> Schedule:
    """The reference's 'tri' construction (utils/model_utils.py:70-76):
    CyclicLR(base=lr/10, max=lr*10, step_size_up=epochs//8); falls back to
    constant when epochs < 8 like the reference's guard."""
    if epochs < 8:
        return constant(lr)
    return triangular2(lr / 10, lr * 10, max(epochs // 8, 1))


def delayed(delay_steps: int, initial_lr: float, after: Schedule) -> Schedule:
    """Flat lr for `delay_steps`, then hand over to `after` with its clock
    re-zeroed (reference DelayerScheduler, utils/model_utils.py:11-44)."""

    def fn(step: int) -> float:
        if step < delay_steps:
            return initial_lr
        return after(step - delay_steps)

    return fn


def build_schedule(
    name: str, lr: float, epochs: int, lr_decay: float = 0.99
) -> Schedule:
    """Registry keyed by the reference's `opt_scheduler` values."""
    name = (name or "").lower()
    if name == "tri":
        return tri_from_config(lr, epochs)
    if name == "step":
        return step_decay(lr)
    if name in ("exp", "exponential"):
        return exponential(lr, lr_decay)
    if name in ("cosine", "cos"):
        # the reference's eta_min == lr quirk: effectively constant
        return cosine_annealing(lr, epochs, eta_min=lr)
    return constant(lr)
