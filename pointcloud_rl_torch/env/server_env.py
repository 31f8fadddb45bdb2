"""Server-style vec env: batched observation fusion on the device.

Port of ``pointcloud_rl_tpu/env/server_env.py``.  The env workers run the
simulator in ``obs_mode="raw"`` and ship the render products (depth, rgb,
camera pose); one call of ``ops/obs_fuse.py`` per batch unprojects,
ground/body-splits and downsamples every env's stacked frames on an
explicit ``device`` and returns the FrameStack point-cloud contract as
numpy, so the rollout, the replay and the agent see what the host
pipeline gives them.

The fusion runs where it is told: on ``cuda`` without a GPU the
constructor raises; nothing moves to the CPU on its own.  This module
imports torch only inside the class, like the other env modules.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..utils.trace import OBS_FUSE, span
from .vec_env import VectorEnvBase


class ServerObsVectorEnv(VectorEnvBase):
    """Wraps an inner vec env of raw-obs workers; every observation batch is
    fused to point clouds on ``device`` before it reaches the caller."""

    def __init__(self, inner, num_frames: int = 1, seed: Optional[int] = None, device="cuda"):
        import torch

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServerObsVectorEnv on 'cuda' was asked for, but torch.cuda.is_available() is false")
        self.inner = inner
        self.num_envs = inner.num_envs
        self.num_frames = int(num_frames)
        self.obs_mode = "pointcloud"  # downstream contract after fusion
        self.generator = torch.Generator(device=self.device).manual_seed(0 if seed is None else int(seed))
        # fusion constants of the first worker's env (the same for every worker)
        self._fuse_kw = dict(
            n_points=int(inner.get_attr("n_points")),
            num_ground=int(inner.get_attr("num_ground")),
            ground_eps=float(inner.get_attr("ground_eps")),
            max_depth=float(inner.get_attr("max_depth")),
            z_to_world=bool(inner.get_attr("z_to_world")),
            fix_base_z=inner.get_attr("fix_base_z"),
        )
        self._inv_k = torch.as_tensor(np.asarray(inner.get_attr("inv_intrinsic"), np.float32), device=self.device)

    # ------------------------------------------------------------- fusion
    def _fuse(self, raw: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        import torch

        from ..ops.obs_fuse import dmc_raw_to_pointcloud

        with span(OBS_FUSE):
            depth, rgb, cam = (torch.as_tensor(np.asarray(raw[k])).to(self.device) for k in ("depth", "rgb", "cam"))
            out = dmc_raw_to_pointcloud(depth, rgb, cam, self._inv_k, generator=self.generator, **self._fuse_kw)
            fused = {k: v.cpu().numpy() for k, v in out.items()}
        if self.num_frames == 1:
            fused.pop("pos_encoding")  # the unstacked contract has no frame channel
        return fused

    # ---------------------------------------------------------- vec-env API
    def reset(self, idx=None, **kwargs):
        return self._fuse(self.inner.reset(idx=idx, **kwargs))

    def step(self, actions, idx=None):
        self.step_async(actions, idx)
        return self.step_wait(idx)

    def step_async(self, actions, idx=None) -> None:
        self.inner.step_async(actions, idx)

    def step_poll(self, idx=None) -> bool:
        return self.inner.step_poll(idx)

    def step_wait(self, idx=None):
        obs, rewards, dones, infos = self.inner.step_wait(idx)
        return self._fuse(obs), rewards, dones, infos

    def step_random_actions(self, num):
        batch = self.inner.step_random_actions(num)
        for key in ("obs", "next_obs"):
            if key in batch and isinstance(batch[key], dict) and "depth" in batch[key]:
                batch[key] = self._fuse(batch[key])
        return batch

    def render(self, mode="rgb_array", idx=None, **kwargs):
        return self.inner.render(mode=mode, idx=idx, **kwargs)

    def get_env_state(self):
        return self.inner.get_env_state()

    def call(self, name, *args, idx=None, **kwargs):
        return self.inner.call(name, *args, idx=idx, **kwargs)

    def get_attr(self, name, idx=None):
        return self.inner.get_attr(name, idx=idx)

    def seed(self, seed):
        self.generator.manual_seed(int(seed))
        return self.inner.seed(seed)

    def close(self):
        return self.inner.close()

    def __getattr__(self, name):
        return getattr(self.inner, name)
