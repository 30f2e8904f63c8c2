"""Optimizers and learning-rate schedules — the port of
distributedmnist_tpu/optim.py.

A schedule is a plain function step -> lr with optax's formulas
(`optax.linear_schedule`, `optax.warmup_cosine_decay_schedule`, whose
`decay_steps` includes the warmup). optax evaluates it at the update
count before the increment, so the first update uses lr(0); here the
optimizer is built with lr 1.0 under a `LambdaLR` whose factor is the
schedule itself, stepped after each `optimizer.step()`, which gives the
same order and sets each group's lr to schedule(count) exactly.

- sgd: optax `sgd(momentum=0.9)` is `trace` then a scale by -lr, which
  is `torch.optim.SGD(momentum=0.9, dampening=0, nesterov=False)`.
- adam: optax `adam` (eps outside the sqrt, eps_root=0) and
  `torch.optim.Adam` compute the same function in another rounding
  order.

`flat=True` (the default, config flat_optimizer) uses torch's
multi-tensor (`foreach`) update, the counterpart of the JAX package's
flat update (optax.flatten): one fused update across all parameters;
`flat=False` updates parameter by parameter. Both compute the same
numbers. A parameter's optimizer state has its dtype (bfloat16 moments
for bfloat16 parameters, as optax's per-leaf state with mu_dtype None).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import torch

Schedule = Callable[[int], float]


def _linear(init_value: float, end_value: float,
            transition_steps: int) -> Schedule:
    """optax.linear_schedule (polynomial_schedule with power 1)."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        count = min(max(count, 0), transition_steps)
        frac = 1 - count / transition_steps
        return (init_value - end_value) * frac + end_value
    return schedule


def _cosine_decay(init_value: float, decay_steps: int) -> Schedule:
    """optax.cosine_decay_schedule with alpha=0 and exponent=1."""
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}.")

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        return init_value * (0.5 * (1 + math.cos(math.pi * count
                                                 / decay_steps)))
    return schedule


def make_schedule(learning_rate: float, schedule: str = "constant",
                  warmup_steps: int = 0,
                  total_steps: Optional[int] = None) -> Schedule:
    """step -> lr. {constant, cosine, warmup-cosine}; cosine decays to 0
    over total_steps (required for the cosine variants)."""
    if schedule == "constant":
        if warmup_steps:
            return _linear(0.0, learning_rate, warmup_steps)
        return lambda count: learning_rate
    if schedule in ("cosine", "warmup-cosine"):
        if not total_steps:
            raise ValueError(f"{schedule} schedule needs total_steps")
        if schedule == "warmup-cosine" and warmup_steps <= 0:
            raise ValueError(
                "warmup-cosine needs --warmup-steps > 0 (with 0 it would "
                "silently start at peak LR; use 'cosine' for that)")
        # optax.warmup_cosine_decay_schedule: a linear warmup joined at
        # warmup_steps to a cosine over the remaining steps
        warm = _linear(0.0 if warmup_steps else learning_rate,
                       learning_rate, warmup_steps)
        decay = _cosine_decay(learning_rate, total_steps - warmup_steps)

        def joined(count: int) -> float:
            return warm(count) if count < warmup_steps \
                else decay(count - warmup_steps)
        return joined
    raise ValueError(f"unknown lr schedule {schedule!r}")


def build(name: str, params: Iterable[torch.nn.Parameter],
          schedule: Schedule, momentum: float = 0.9, flat: bool = True):
    """(optimizer, scheduler) over `params`. Call `scheduler.step()` after
    every `optimizer.step()`."""
    if name == "sgd":
        opt = torch.optim.SGD(params, lr=1.0, momentum=momentum,
                              dampening=0.0, nesterov=False, foreach=flat)
    elif name == "adam":
        opt = torch.optim.Adam(params, lr=1.0, betas=(0.9, 0.999),
                               eps=1e-8, foreach=flat)
    else:
        raise ValueError(f"unknown optimizer {name!r} (expected sgd|adam)")
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)
