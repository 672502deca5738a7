"""LR schedule registry + factory (counterpart of
scaletorch_tpu/trainer/lr_scheduler.py).

A ``register_scheduler`` registry and a factory covering linear / cosine
/ polynomial / step / onecycle / constant, each wrapped with linear
warmup (onecycle ramps on its own). A schedule is a pure function
``step -> lr`` of the update count, evaluated BEFORE the count advances,
as optax evaluates it; the formulas are optax's, written out in plain
Python (``torch.optim.lr_scheduler`` is not used).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence

Schedule = Callable[[int], float]

_SCHEDULERS: Dict[str, Callable] = {}


def register_scheduler(name: str, fn: Callable = None):
    """Register ``make(cfg) -> Schedule``. Usable as a decorator."""

    def _register(f):
        _SCHEDULERS[name] = f
        return f

    if fn is not None:
        return _register(fn)
    return _register


# ---- the optax schedules used by the factory ----------------------------------
def constant_schedule(value: float) -> Schedule:
    return lambda count: value


def polynomial_schedule(init_value: float, end_value: float, power: float,
                        transition_steps: int) -> Schedule:
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count):
        count = min(max(count, 0), transition_steps)
        frac = 1 - count / transition_steps
        return (init_value - end_value) * frac ** power + end_value

    return schedule


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    return polynomial_schedule(init_value, end_value, 1, transition_steps)


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(
            "The cosine_decay_schedule requires positive decay_steps, got "
            f"decay_steps={decay_steps}.")

    def schedule(count):
        count = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float, staircase: bool = False) -> Schedule:
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: init_value

    def schedule(count):
        p = count / transition_steps
        if staircase:
            p = math.floor(p)
        return init_value if count <= 0 else init_value * decay_rate ** p

    return schedule


def cosine_onecycle_schedule(transition_steps: int, peak_value: float,
                             pct_start: float = 0.3, div_factor: float = 25.0,
                             final_div_factor: float = 1e4) -> Schedule:
    """optax's cosine one-cycle: a cosine ramp from peak/div_factor to the
    peak over pct_start of the steps, then a cosine decay to
    peak/(div_factor*final_div_factor)."""
    if transition_steps <= 0:
        raise ValueError("A linear onecycle schedule was set with a "
                         "non-positive `transition_steps`")
    scales = sorted({int(pct_start * transition_steps): div_factor,
                     int(transition_steps):
                     1.0 / (div_factor * final_div_factor)}.items())
    bounds = [0] + [b for b, _ in scales]
    values = [peak_value / div_factor]
    for _, s in scales:
        values.append(values[-1] * s)

    def schedule(count):
        for lo, hi, v0, v1 in zip(bounds[:-1], bounds[1:], values[:-1],
                                  values[1:]):
            if lo <= count < hi:
                pct = (count - lo) / (hi - lo)
                return v1 + (v0 - v1) / 2.0 * (math.cos(math.pi * pct) + 1)
        return values[-1] if count >= bounds[-1] else 0.0

    return schedule


def join_schedules(schedules: Sequence[Schedule],
                   boundaries: Sequence[int]) -> Schedule:
    def schedule(step):
        output = schedules[0](step)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if step >= boundary:
                output = sched(step - boundary)
        return output

    return schedule


# ---- the registry ---------------------------------------------------------------
def _warmup_steps(cfg) -> int:
    if cfg.warmup_steps:
        return cfg.warmup_steps
    return int(cfg.warmup_ratio * cfg.total_train_steps)


def _with_warmup(cfg, schedule: Schedule) -> Schedule:
    w = _warmup_steps(cfg)
    if w <= 0:
        return schedule
    warmup = linear_schedule(0.0, cfg.learning_rate, w)
    return join_schedules([warmup, schedule], [w])


@register_scheduler("constant")
def _constant(cfg):
    return _with_warmup(cfg, constant_schedule(cfg.learning_rate))


@register_scheduler("linear")
def _linear(cfg):
    decay = max(cfg.total_train_steps - _warmup_steps(cfg), 1)
    end = cfg.learning_rate * cfg.min_lr_ratio
    return _with_warmup(cfg, linear_schedule(cfg.learning_rate, end, decay))


@register_scheduler("cosine")
def _cosine(cfg):
    decay = max(cfg.total_train_steps - _warmup_steps(cfg), 1)
    return _with_warmup(
        cfg, cosine_decay_schedule(cfg.learning_rate, decay,
                                   alpha=cfg.min_lr_ratio))


@register_scheduler("polynomial")
def _polynomial(cfg):
    decay = max(cfg.total_train_steps - _warmup_steps(cfg), 1)
    return _with_warmup(
        cfg, polynomial_schedule(cfg.learning_rate,
                                 cfg.learning_rate * cfg.min_lr_ratio,
                                 cfg.poly_power, decay))


@register_scheduler("step")
def _step(cfg):
    return _with_warmup(
        cfg, exponential_decay(cfg.learning_rate, cfg.step_size,
                               cfg.step_gamma, staircase=True))


@register_scheduler("onecycle")
def _onecycle(cfg):
    # onecycle defines its own ramp; no extra warmup wrapper
    return cosine_onecycle_schedule(max(cfg.total_train_steps, 1),
                                    cfg.learning_rate)


def create_lr_scheduler(cfg) -> Schedule:
    """cfg needs: lr_scheduler_type, learning_rate, total_train_steps,
    warmup_steps/warmup_ratio, min_lr_ratio (+ per-type knobs)."""
    name = cfg.lr_scheduler_type
    if name not in _SCHEDULERS:
        raise KeyError(
            f"unknown lr scheduler {name!r}; have {sorted(_SCHEDULERS)}")
    return _SCHEDULERS[name](cfg)
