# Copy of pointcloud_rl_tpu/env/gym_adapter.py for the PyTorch port (that package's env imports JAX).
"""Adapter exposing gymnasium envs through the classic step contract."""

from __future__ import annotations

import numpy as np

from .api import Env
from .spaces import from_gymnasium


class GymnasiumAdapter(Env):
    def __init__(self, env):
        self.env = env
        self.action_space = from_gymnasium(env.action_space)
        self._seed = None

    def reset(self, **kwargs):
        obs, _info = self.env.reset(seed=self._seed, **kwargs)
        self._seed = None
        return obs

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        done = bool(terminated or truncated)
        if truncated and not terminated:
            info["TimeLimit.truncated"] = True
        return obs, float(reward), done, info

    def seed(self, seed):
        self._seed = seed
        self.action_space.seed(seed)

    def render(self, mode="rgb_array", **kwargs):
        return self.env.render()

    def close(self):
        self.env.close()
