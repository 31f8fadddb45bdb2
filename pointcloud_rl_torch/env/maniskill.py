# Copy of pointcloud_rl_tpu/env/maniskill.py for the PyTorch port (that package's env imports JAX).
"""ManiSkill (SAPIEN) integration, gated on the sapien/mani_skill packages.

Parity target: reference ``pyrl/env/maniskill_wrappers.py`` —
``ManiSkillObsWrapper`` flattens SAPIEN observations into
{xyz, rgb (uint8), seg, state}, applies the seg-aware balanced downsample
``pcd_base`` (obs_process.py), and transposes to the channel-first env
contract.  SAPIEN is host-side C++/Vulkan simulation; it is not shipped in
this image, so construction raises a clear error unless sapien+mani_skill
are importable.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .api import Env, Wrapper
from .obs_process import pcd_base
from .spaces import Box


def _require_maniskill():
    try:
        import sapien  # noqa: F401
        import mani_skill.env  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "ManiSkill environments need the `sapien` and `mani_skill` packages "
            "(host-side C++/Vulkan simulator). Install them to use OpenCabinet*/"
            "PushChair*/MoveBucket* envs; DM Control and DistEnv work without them."
        ) from e


class ManiSkillObsWrapper(Wrapper):
    """Flatten ManiSkill obs -> {xyz, rgb, seg, state}, seg-balanced
    downsample, channel-first transpose (maniskill_wrappers.py:142-199)."""

    def __init__(self, env, n_points: int = 1200, min_pts: int = 50, fg_pts: int = 800):
        super().__init__(env)
        self.n_points = n_points
        self.min_pts = min_pts
        self.fg_pts = fg_pts
        self.obs_mode = getattr(env, "obs_mode", "pointcloud")

    def _process(self, obs):
        if not isinstance(obs, dict):
            return obs  # obs_mode == "state" passthrough
        # agent state: "state" preferred over "agent", with target_info
        # appended when the task provides it (maniskill_wrappers.py:158-163)
        state = obs.get("state", obs.get("agent"))
        target_info = obs.get("target_info")
        if state is not None and target_info is not None:
            state = np.concatenate([np.asarray(state).ravel(),
                                    np.asarray(target_info).ravel()])
        if "pointcloud" not in obs:
            # image modes: HWC -> CHW, rgb to uint8
            # (maniskill_wrappers.py:175-178)
            if self.obs_mode in ("rgb", "rgbd", "depth") and self.obs_mode in obs:
                out = {}
                for k, v in dict(obs[self.obs_mode]).items():
                    v = np.asarray(v)
                    if k == "rgb" and v.dtype != np.uint8:
                        v = (np.clip(v, 0, 1) * 255).astype(np.uint8)
                    out[k] = np.ascontiguousarray(v.transpose(2, 0, 1))
                if state is not None:
                    out["state"] = np.asarray(state, np.float32)
                return out
            return obs
        pcd = dict(obs["pointcloud"])
        pcd = pcd_base(pcd, n_points=self.n_points, min_pts=self.min_pts, fg_pts=self.fg_pts)
        out = {}
        for k in ("xyz", "rgb", "seg"):
            if k in pcd:
                v = pcd[k]
                if k == "rgb" and v.dtype != np.uint8:
                    v = (np.clip(v, 0, 1) * 255).astype(np.uint8)
                out[k] = np.ascontiguousarray(v.T)
        if state is not None:
            out["state"] = np.asarray(state, np.float32)
        return out

    def reset(self, **kwargs):
        return self._process(self.env.reset(**kwargs))

    def step(self, action):
        obs, r, d, info = self.env.step(action)
        return self._process(obs), r, d, info


def build_maniskill_env(env_name: str, obs_mode: str = "pointcloud", **kwargs) -> Env:
    _require_maniskill()
    import gym as legacy_gym  # mani_skill registers into classic gym

    n_points = kwargs.pop("n_points", 1200)
    env = legacy_gym.make(env_name, **kwargs)
    env.set_env_mode(obs_mode=obs_mode)
    wrapped = ManiSkillObsWrapper(env, n_points=n_points)
    wrapped.obs_mode = obs_mode
    return wrapped
