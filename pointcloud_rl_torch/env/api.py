# Copy of pointcloud_rl_tpu/env/api.py for the PyTorch port (that package's env imports JAX).
"""Core env protocol and the Extended/TimeLimit wrappers.

The step contract follows the reference's (classic-gym style,
``obs, reward, done, info = env.step(action)``; reference pyrl/env/wrappers.py):

* ``TimeLimit`` marks truncation via ``info["TimeLimit.truncated"]``.
* ``true_done(done, info)`` strips time-limit truncation from done so the
  bootstrap target does not treat truncation as termination
  (reference env_utils.py:73-83).
* ``ExtendedEnv`` scales rewards, downcasts f64->f32, injects per-step
  timing, and provides ``step_random_actions`` (full transition dicts built
  in-env for warm-up) and ``step_states_actions`` (MPC).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..utils.tree_ops import f64_to_f32, tree_assign, tree_empty_like_with_capacity, tree_map
from .spaces import Box, Discrete, Space


class Env:
    """Base environment protocol.

    Note: no class-level attribute defaults here — wrappers forward missing
    attributes via ``__getattr__``, and a class default (e.g. obs_mode) would
    shadow the wrapped env's value.
    """

    action_space: Space
    obs_mode: str

    def reset(self, **kwargs):
        raise NotImplementedError

    def step(self, action) -> Tuple[Any, float, bool, dict]:
        raise NotImplementedError

    def seed(self, seed: Optional[int]) -> None:
        pass

    def render(self, mode: str = "rgb_array", **kwargs):
        raise NotImplementedError

    def get_obs(self):
        raise NotImplementedError

    def get_env_state(self) -> dict:
        return {}

    def close(self) -> None:
        pass


class Wrapper(Env):
    def __init__(self, env: Env):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self, **kwargs):
        return self.env.reset(**kwargs)

    def step(self, action):
        return self.env.step(action)

    def seed(self, seed):
        return self.env.seed(seed)

    def render(self, mode="rgb_array", **kwargs):
        return self.env.render(mode, **kwargs)

    # explicit forwarding: these have defaults on Env, which would otherwise
    # shadow the wrapped env's implementations (__getattr__ is a fallback)
    def get_obs(self):
        return self.env.get_obs()

    def get_env_state(self):
        return self.env.get_env_state()

    def close(self):
        return self.env.close()


def true_done(done, info) -> np.bool_:
    """done with TimeLimit truncation stripped (reference env_utils.py:73-83)."""
    truncated = info.get("TimeLimit.truncated", True) if isinstance(info, dict) else True
    if isinstance(done, (bool, np.bool_)):
        return np.bool_(False) if truncated else np.bool_(done)
    truncated = np.asarray(truncated)
    if truncated.dtype.kind == "f":
        truncated = truncated > 0.5
    return np.logical_and(done, ~truncated)


class TimeLimit(Wrapper):
    def __init__(self, env: Env, max_episode_steps: int):
        super().__init__(env)
        self._max_episode_steps = int(max_episode_steps)
        self._elapsed = 0

    def reset(self, **kwargs):
        self._elapsed = 0
        return self.env.reset(**kwargs)

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        self._elapsed += 1
        if self._elapsed >= self._max_episode_steps:
            info["TimeLimit.truncated"] = not done
            done = True
        return obs, reward, done, info


class ExtendedEnv(Wrapper):
    """Reward scaling + dtype discipline + warm-up helpers
    (reference wrappers.py:55-157)."""

    def __init__(self, env: Env, reward_scale: float = 1.0, use_cost: bool = False):
        super().__init__(env)
        assert reward_scale > 0, "Reward scale should be positive"
        self.is_discrete = isinstance(env.action_space, Discrete)
        self.is_cost = -1 if use_cost else 1
        self.reward_scale = reward_scale * self.is_cost

    def _process_action(self, action):
        if self.is_discrete and not np.isscalar(action):
            action = int(np.asarray(action).reshape(-1)[0])
        return action

    def reset(self, **kwargs):
        return f64_to_f32(self.env.reset(**kwargs))

    def step(self, action):
        t0 = time.monotonic()
        obs, reward, done, info = self.env.step(self._process_action(action))
        if isinstance(info, dict):
            info.setdefault("TimeLimit.truncated", False)
        obs = f64_to_f32(obs)
        info = f64_to_f32(info) if isinstance(info, dict) else info
        info["step_times"] = time.monotonic() - t0
        return obs, np.float32(reward * self.reward_scale), np.bool_(done), info

    def step_random_actions(self, num: int) -> Dict[str, Any]:
        """Collect ``num`` random-action transitions as a flat batch dict
        (reference wrappers.py:106-141); resets on done."""
        buf = None
        obs = self.reset()
        prev_action = None
        for i in range(num):
            action = np.asarray(self.env.action_space.sample())
            if action.ndim == 0:
                action = action[None]
            if prev_action is None:
                prev_action = np.zeros_like(action)
            next_obs, reward, done, info = self.step(action)
            item = dict(
                obs=obs,
                next_obs=next_obs,
                actions=action.copy(),
                prev_actions=prev_action.copy(),
                rewards=np.float32(reward),
                dones=true_done(done, info),
                episode_dones=np.bool_(done),
                worker_indices=np.int32(0),
            )
            if buf is None:
                buf = tree_empty_like_with_capacity(item, num, batched=False)
            tree_assign(buf, i, item)
            prev_action = action.copy()
            obs = next_obs
            if done:
                obs = self.reset()
                prev_action = np.zeros_like(action)
        # Ensure leading batch axis semantics: rewards/dones are [num]; add
        # trailing dim for scalars to match vec-env layout [num, 1].
        for key in ("rewards", "dones", "episode_dones", "worker_indices"):
            buf[key] = buf[key][:, None]
        return buf

    def step_states_actions(self, states=None, actions=None) -> np.ndarray:
        """Rollout reward eval for MPC/CEM: actions [N, L, A] -> rewards [N, L, 1]
        (reference wrappers.py:143-157)."""
        assert actions.ndim == 3
        rewards = np.zeros_like(actions[..., :1], dtype=np.float32)
        for i in range(len(actions)):
            if states is not None and hasattr(self.env, "set_state"):
                self.env.set_state(states[i])
            for j in range(len(actions[i])):
                rewards[i, j] = self.step(actions[i, j])[1]
        return rewards


class FrameStackWrapper(Wrapper):
    """Frame stacking (reference wrappers.py:242-270): point clouds concat
    along the point axis and gain a one-hot per-frame ``pos_encoding``
    channel; images concat along the channel axis."""

    def __init__(self, env: Env, num_frames: int):
        super().__init__(env)
        self.num_frames = int(num_frames)
        self.obs_mode = getattr(env, "obs_mode", "state")
        self.frames = []
        self.pos_encoding = np.eye(self.num_frames, dtype=np.uint8)

    def observation(self):
        if self.obs_mode == "pointcloud":
            num_points = self.frames[0]["xyz"].shape[-1]
            obs = tree_map(lambda *xs: np.concatenate(xs, axis=-1), *self.frames)
            obs["pos_encoding"] = np.repeat(self.pos_encoding, num_points, axis=-1)
            return obs
        return tree_map(lambda *xs: np.concatenate(xs, axis=-3), *self.frames)

    def reset(self, **kwargs):
        obs = self.env.reset(**kwargs)
        self.frames = [obs] * self.num_frames
        return self.observation()

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        self.frames = self.frames[1:] + [obs]
        return self.observation(), reward, done, info


class MuJoCoVisualWrapper(Wrapper):
    """Expose a state-based mujoco env as rgb observations with action
    repeat (reference wrappers.py:274 MuJoCoVisual)."""

    def __init__(self, env: Env, img_size=(84, 84), action_repeat: int = 2):
        super().__init__(env)
        self.img_size = tuple(img_size)
        self.action_repeat = int(action_repeat)
        self.obs_mode = "rgb"

    def _get_obs(self):
        rgb = self.env.render("rgb_array", width=self.img_size[0], height=self.img_size[1])
        return {"rgb": np.ascontiguousarray(np.asarray(rgb).transpose(2, 0, 1))}

    def reset(self, **kwargs):
        self.env.reset(**kwargs)
        return self._get_obs()

    def step(self, action):
        reward, done, info = 0.0, False, {}
        for _ in range(self.action_repeat):
            _, r, done, info = self.env.step(action)
            reward += r
            if done:
                break
        return self._get_obs(), reward, done, info


class FixedInitWrapper(Wrapper):
    """Reset with a fixed state (reference wrappers.py:204)."""

    def __init__(self, env: Env, init_state):
        super().__init__(env)
        self.init_state = np.asarray(init_state)

    def reset(self, **kwargs):
        obs = self.env.reset(**kwargs)
        if hasattr(self.env, "set_state"):
            self.env.set_state(self.init_state)
            obs = self.env.get_obs()
        return obs
