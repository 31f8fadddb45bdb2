# Copy of pointcloud_rl_tpu/env/spaces.py for the PyTorch port (that package's env imports JAX).
"""Minimal action/observation spaces (gym is not a dependency).

Covers the Box/Discrete surface the framework uses, plus stacked variants for
vectorized envs (reference pyrl/env/action_space_utils.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class Space:
    def seed(self, seed: Optional[int]) -> None:
        self._rng = np.random.RandomState(seed)

    @property
    def rng(self) -> np.random.RandomState:
        if not hasattr(self, "_rng"):
            self._rng = np.random.RandomState()
        return self._rng


class Box(Space):
    def __init__(self, low, high, shape=None, dtype=np.float32):
        if shape is None:
            shape = np.broadcast(np.asarray(low), np.asarray(high)).shape
        self.shape = tuple(shape)
        self.low = np.broadcast_to(np.asarray(low, dtype), self.shape).copy()
        self.high = np.broadcast_to(np.asarray(high, dtype), self.shape).copy()
        self.dtype = dtype

    def sample(self) -> np.ndarray:
        r = self.rng.uniform(size=self.shape).astype(self.dtype)
        return self.low + r * (self.high - self.low)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return x.shape == self.shape and bool((x >= self.low - 1e-6).all() and (x <= self.high + 1e-6).all())

    def is_bounded(self) -> bool:
        return bool(np.isfinite(self.low).all() and np.isfinite(self.high).all())

    def __repr__(self):
        return f"Box(shape={self.shape}, low={self.low.min()}, high={self.high.max()})"


class Discrete(Space):
    def __init__(self, n: int):
        self.n = int(n)
        self.shape = ()

    def sample(self) -> int:
        return int(self.rng.randint(self.n))

    def contains(self, x) -> bool:
        return 0 <= int(x) < self.n

    def is_bounded(self) -> bool:
        return True

    def __repr__(self):
        return f"Discrete({self.n})"


def stack_action_space(space: Space, num: int) -> Space:
    """Vectorized space over num envs (reference action_space_utils.py:6-26)."""
    if isinstance(space, Box):
        low = np.repeat(space.low[None], num, 0)
        high = np.repeat(space.high[None], num, 0)
        return Box(low, high, (num,) + space.shape, space.dtype)
    if isinstance(space, Discrete):
        return StackedDiscrete(space.n, num)
    raise TypeError(f"Cannot stack space {space}")


class StackedDiscrete(Space):
    def __init__(self, n: int, num: int):
        self.n = int(n)
        self.num = int(num)
        self.shape = (num,)

    def sample(self) -> np.ndarray:
        return self.rng.randint(self.n, size=(self.num, 1))

    def is_bounded(self) -> bool:
        return True


def from_gymnasium(space) -> Space:
    """Adapter for gymnasium spaces (used by external env integrations)."""
    name = type(space).__name__
    if name == "Box":
        return Box(space.low, space.high, space.shape, space.dtype)
    if name == "Discrete":
        return Discrete(space.n)
    raise TypeError(f"Unsupported gymnasium space {space}")
