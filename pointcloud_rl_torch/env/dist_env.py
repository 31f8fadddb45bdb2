# Copy of pointcloud_rl_tpu/env/dist_env.py for the PyTorch port (that package's env imports JAX).
"""Synthetic motivating-example environment.

Parity target: reference ``pyrl/env/external_envs/simple_dist_env.py``
(DistEnv, registered as ``reacher3d_easy-v0``): a one-step 3D reaching task —
a source and target pixel are placed on an image plane with random depths;
the agent observes them (state vector, rgb/rgbd image, or a 2-point
pointcloud) and outputs a 3D displacement; the reward is the negative
distance between the moved source and the target.  No native deps, so it is
the fast end-to-end sanity check for the whole stack.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .api import Env
from .spaces import Box


class DistEnv(Env):
    def __init__(
        self,
        image_size=20,
        n=2,
        obs_mode="state",
        max_depth=2,
        pad=2,
        ego_mode=False,
        box_size=1,
        max_dist=5,
        min_dist=2,
    ):
        if isinstance(image_size, (list, tuple)):
            image_size = image_size[0]
        self.img_size = int(image_size)
        self.obs_mode = obs_mode
        self.max_depth = max_depth
        self.pad = pad
        self.ego_mode = ego_mode
        self.box_size = box_size
        self.max_dist = max_dist
        self.min_dist = min_dist
        self.action_space = Box(-1.0, 1.0, (3,))
        # Pinhole intrinsics: focal 20, principal point at the image center.
        c = (self.img_size - 1) / 2.0
        self.intrinsic = np.array([[20.0, 0, c], [0, 20.0, c], [0, 0, 1.0]])
        self.np_random = np.random.RandomState()
        self._step = 0

    @property
    def inv_intrinsic(self) -> np.ndarray:
        return np.linalg.inv(self.intrinsic)

    def seed(self, seed):
        self.action_space.seed(seed)
        self.np_random.seed(seed)

    def _unproject(self, pixels_rc: np.ndarray, depths: np.ndarray) -> np.ndarray:
        """(row, col) pixel coords + depths -> camera-frame xyz."""
        uv1 = np.stack([pixels_rc[:, 1] + 0.5, pixels_rc[:, 0] + 0.5, np.ones(len(pixels_rc))], axis=-1)
        return uv1 @ self.inv_intrinsic.T * depths[:, None]

    def reset(self, **kwargs):
        while True:
            self.source = self.np_random.randint(self.img_size - self.pad, size=2) + self.pad
            self.target = self.np_random.randint(self.img_size - self.pad, size=2) + self.pad
            self.source_depth, self.target_depth = self.np_random.rand(2) * self.max_depth
            xyz = self._unproject(
                np.stack([self.source, self.target]), np.array([self.source_depth, self.target_depth])
            )
            self.source_xyz, self.target_xyz = xyz[0], xyz[1]
            if self.min_dist < np.linalg.norm(self.source_xyz - self.target_xyz) < self.max_dist:
                break
        self._step = 0
        return self.get_obs()

    def _paint(self):
        rgb = np.zeros([3, self.img_size, self.img_size], np.uint8)
        depth = np.zeros([1, self.img_size, self.img_size], np.float32)
        half = self.box_size // 2
        for di in range(-half, half + 1):
            for dj in range(-half, half + 1):
                for (pt, d, color) in ((self.source, self.source_depth, (255, 0, 0)), (self.target, self.target_depth, (0, 0, 255))):
                    r, c = pt[0] + di, pt[1] + dj
                    if 0 <= r < self.img_size and 0 <= c < self.img_size:
                        rgb[:, r, c] = color
                        depth[:, r, c] = d
        return rgb, depth

    def get_obs(self, obs_mode: Optional[str] = None):
        mode = obs_mode or self.obs_mode
        if mode == "state":
            return np.float32(np.concatenate([self.source, self.target]))
        if mode == "rgb":
            rgb, _ = self._paint()
            return {"rgb": rgb}
        rgb, depth = self._paint()
        if mode == "rgbd":
            return {"rgb": rgb, "depth": np.float32(depth / self.max_depth)}
        if mode == "xyz-img":
            v, u = np.indices(depth[0].shape)
            uv1 = np.stack([u + 0.5, v + 0.5, np.ones_like(depth[0])], axis=-1)
            xyz = (uv1 @ self.inv_intrinsic.T) * depth[0][..., None]
            return {"rgb": rgb, "xyz": xyz.transpose(2, 0, 1).astype(np.float32)}
        if mode == "pointcloud":
            xyz = np.stack([self.source_xyz, self.target_xyz]).astype(np.float32)
            if self.ego_mode:
                xyz = xyz.copy()
                xyz[1] -= xyz[0]
            rgb_pts = np.array([[255, 0, 0], [0, 0, 255]], np.uint8)
            return {"xyz": xyz.T, "rgb": rgb_pts.T}  # channel-first [3, 2]
        raise KeyError(f"Unknown obs_mode {mode}")

    def set_obs_mode(self, obs_mode: str):
        self.obs_mode = obs_mode

    def render(self, mode="rgb_array", **kwargs):
        rgb, _ = self._paint()
        return rgb.transpose(1, 2, 0)

    def step(self, action):
        assert self._step == 0, "DistEnv is a single-step environment"
        self._step += 1
        action = np.asarray(action, np.float64) * self.max_dist
        moved = self.source_xyz + action
        reward = -float(np.linalg.norm(moved - self.target_xyz))
        proj = moved @ self.intrinsic.T
        self.source_depth = max(proj[-1], 1e-3)
        self.source = np.clip(np.int32(proj[:2] / proj[-1]), 0, self.img_size - 1)
        return self.get_obs(), reward, True, {}
