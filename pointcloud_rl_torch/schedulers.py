"""Hyper-parameter schedulers (port of ``pointcloud_rl_tpu/schedulers.py``).

Config-driven step -> value schedules for any scalar hyper-parameter, and
learning-rate schedules (``build_lr_schedule``): cosine, linear and
exponential decay in plain Python, each returning what its optax
counterpart returns at every step.
"""

from __future__ import annotations

import math
from typing import Sequence

from .registry import Registry, build_from_cfg

SCHEDULERS = Registry("scheduler")


@SCHEDULERS.register_module(name="FixedScheduler")
@SCHEDULERS.register_module()
class Fixed:
    def __init__(self, value: float):
        self.value = value

    def get(self, step: int) -> float:
        return self.value

    __call__ = get


@SCHEDULERS.register_module(name="StepScheduler")
@SCHEDULERS.register_module()
class Step:
    """Multiply by gamma at each milestone step."""

    def __init__(self, value: float, milestones: Sequence[int], gamma: float = 0.1):
        self.value = value
        self.milestones = sorted(milestones)
        self.gamma = gamma

    def get(self, step: int) -> float:
        v = self.value
        for m in self.milestones:
            if step >= m:
                v *= self.gamma
        return v

    __call__ = get


@SCHEDULERS.register_module(name="KeyStepScheduler")
@SCHEDULERS.register_module()
class KeyStep:
    """Piecewise-constant: explicit (step, value) pairs."""

    def __init__(self, keys: Sequence[int], values: Sequence[float]):
        assert len(keys) == len(values) and list(keys) == sorted(keys)
        self.keys, self.values = list(keys), list(values)

    def get(self, step: int) -> float:
        v = self.values[0]
        for k, val in zip(self.keys, self.values):
            if step >= k:
                v = val
        return v

    __call__ = get


@SCHEDULERS.register_module(name="LmbdaScheduler")
@SCHEDULERS.register_module()
class Lmbda:
    """value * fn(step) for a user-supplied callable or eval'able string."""

    def __init__(self, value: float, fn):
        self.value = value
        self.fn = eval(fn) if isinstance(fn, str) else fn  # noqa: S307 config-authored

    def get(self, step: int) -> float:
        return self.value * self.fn(step)

    __call__ = get


def build_scheduler(cfg, default_args=None):
    if cfg is None:
        return None
    if isinstance(cfg, (int, float)):
        return Fixed(float(cfg))
    return build_from_cfg(dict(cfg), SCHEDULERS, default_args)


def _cosine_decay(value: float, decay_steps: int, alpha: float = 0.0):
    """``optax.cosine_decay_schedule(value, decay_steps, alpha)``."""
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got {decay_steps=}.")

    def schedule(step):
        count = min(float(step), float(decay_steps))
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return value * ((1 - alpha) * cosine + alpha)

    return schedule


def _linear(value: float, end_value: float, decay_steps: int):
    """``optax.linear_schedule(value, end_value, decay_steps)``."""
    if decay_steps <= 0:
        return lambda step: value

    def schedule(step):
        count = min(max(float(step), 0.0), float(decay_steps))
        return (value - end_value) * (1 - count / decay_steps) + end_value

    return schedule


def _exponential(value: float, decay_steps: int, gamma: float):
    """``optax.exponential_decay(value, decay_steps, gamma)``."""
    if decay_steps <= 0 or gamma == 0:
        return lambda step: value
    return lambda step: value if step <= 0 else value * gamma ** (step / decay_steps)


def build_lr_schedule(cfg):
    """A step -> learning-rate function from a scheduler config (a number
    or None passes through)."""
    if cfg is None or isinstance(cfg, (int, float)):
        return cfg
    cfg = dict(cfg)
    kind = cfg.pop("type")
    if kind in ("cosine", "CosineAnnealing"):
        return _cosine_decay(cfg["value"], cfg["decay_steps"], cfg.get("alpha", 0.0))
    if kind in ("linear", "LinearDecay"):
        return _linear(cfg["value"], cfg.get("end_value", 0.0), cfg["decay_steps"])
    if kind in ("exponential", "ExponentialDecay"):
        return _exponential(cfg["value"], cfg["decay_steps"], cfg.get("gamma", 0.99))
    sched = build_scheduler(dict(type=kind, **cfg))
    return lambda step: sched.get(int(step))
