"""Learning-rate schedules: pure functions of the step.

Counterpart of ``deepspeed_tpu/runtime/lr_schedules.py`` (reference
``deepspeed/runtime/lr_schedules.py``: WarmupLR, WarmupDecayLR, OneCycle,
LRRangeTest), selected by the same JSON ``scheduler`` names. A schedule
maps the integer step to a Python float, so computing the learning rate
never touches the device.
"""
from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]

WARMUP_LOG_RATE = "log"
WARMUP_LINEAR_RATE = "linear"


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
              warmup_num_steps: int = 1000,
              warmup_type: str = WARMUP_LOG_RATE, **_) -> Schedule:
    """WarmupLR: ramp from min to max over ``warmup_num_steps`` (log or
    linear), then hold at max."""
    delta = warmup_max_lr - warmup_min_lr
    wsteps = max(warmup_num_steps, 1)
    log_den = math.log(wsteps + 1)

    def schedule(step):
        step = float(step)
        if step >= wsteps:
            return float(warmup_max_lr)
        if warmup_type == WARMUP_LOG_RATE:
            frac = math.log1p(step) / log_den
        else:
            frac = step / wsteps
        return warmup_min_lr + delta * frac
    return schedule


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                    warmup_type: str = WARMUP_LOG_RATE, **_) -> Schedule:
    """WarmupDecayLR: warmup, then linear decay to 0 at
    ``total_num_steps``."""
    warm = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps,
                     warmup_type)
    wsteps = max(warmup_num_steps, 1)
    decay_steps = max(total_num_steps - wsteps, 1)

    def schedule(step):
        step = float(step)
        if step < wsteps:
            return warm(step)
        frac = min(max((total_num_steps - step) / decay_steps, 0.0), 1.0)
        return warmup_max_lr * frac
    return schedule


def one_cycle(cycle_min_lr: float, cycle_max_lr: float,
              cycle_first_step_size: int = 2000,
              cycle_second_step_size: int = None,
              decay_step_size: int = 0, decay_lr_rate: float = 0.0,
              **_) -> Schedule:
    """OneCycle: up over the first phase, down over the second, then an
    optional decay below min."""
    second = cycle_second_step_size if cycle_second_step_size is not None \
        else cycle_first_step_size
    span = cycle_max_lr - cycle_min_lr

    def schedule(step):
        step = float(step)
        if step <= cycle_first_step_size:
            return cycle_min_lr + span * min(step, cycle_first_step_size) \
                / cycle_first_step_size
        post = step - (cycle_first_step_size + second)
        if post <= 0:
            frac = min(max((step - cycle_first_step_size) / second, 0.0),
                       1.0)
            return cycle_max_lr - span * frac
        if decay_step_size > 0:
            return cycle_min_lr / (1.0 + decay_lr_rate
                                   * math.floor(post / decay_step_size))
        return float(cycle_min_lr)
    return schedule


def lr_range_test(lr_range_test_min_lr: float = 1e-3,
                  lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False, **_) -> Schedule:
    """LRRangeTest: a linearly (or staircase) increasing probe."""
    def schedule(step):
        interval = float(step) / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = math.floor(interval)
        return lr_range_test_min_lr * (1.0 + interval
                                       * lr_range_test_step_rate)
    return schedule


def constant_lr(lr: float = 1e-3, **_) -> Schedule:
    return lambda step: float(lr)


SCHEDULE_REGISTRY = {
    "WarmupLR": warmup_lr,
    "WarmupDecayLR": warmup_decay_lr,
    "OneCycle": one_cycle,
    "LRRangeTest": lr_range_test,
    "ConstantLR": constant_lr,
}


def build_schedule(scheduler_config, optimizer_params: dict = None) -> Schedule:
    """From the JSON ``scheduler`` section; without one, the optimizer's
    fixed ``lr`` (default 1e-3)."""
    if scheduler_config is None:
        return constant_lr((optimizer_params or {}).get("lr", 1e-3))
    name = scheduler_config.type
    if name not in SCHEDULE_REGISTRY:
        raise ValueError(f"unknown scheduler {name!r}; "
                         f"supported: {sorted(SCHEDULE_REGISTRY)}")
    return SCHEDULE_REGISTRY[name](**scheduler_config.params)
