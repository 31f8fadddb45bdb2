# Copy of pointcloud_rl_tpu/env/fake_manipulation.py for the PyTorch port (that package's env imports JAX).
"""Synthetic manipulation environment with ManiSkill-shaped observations.

SAPIEN (the ManiSkill simulator) is host-side C++/Vulkan and not always
installed; this env emits the SAME observation structure the ManiSkill
wrapper produces — a segmented point cloud {xyz, rgb, seg} plus a robot
state vector — from a cheap procedural scene, so every ManiSkill config,
the seg-balanced sampler, and the full training stack can run and be tested
without the simulator.  It is a stand-in for pipeline testing, not a
physics benchmark; reward is a simple reach task.

Contract coverage beyond shapes (reference ``mani_skill/env/base_env.py``):

- ``obs_source="cameras"``: the cloud comes from THREE virtual pinhole
  cameras (the reference mounts three on the robot, camera.py:64-109):
  the scene is z-buffered into per-camera depth/rgb/seg images which are
  unprojected and fused into one world-frame cloud — the same math as
  ``ops/camera.py`` (tested equal); ``obs_source="points"`` (default)
  synthesizes the cloud directly (faster for throughput tests).
- ``ego_mode``: xyz[..., :2] -= base_pos then rotation by -base_orientation
  about z (base_env.py:1199-1212).
- eval flags with ``keep_good_steps`` hysteresis (base_env.py:795-807):
  ``info["eval_info"]["success"]`` requires the success condition to hold
  for ``keep_good_steps_threshold`` consecutive steps.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Optional

import numpy as np

from .api import Env
from .obs_process import pcd_base
from .spaces import Box


def _look_at(eye, target, up=(0.0, 0.0, 1.0)):
    """cam2world [4, 4] for a camera at ``eye`` looking at ``target``
    (OpenCV convention: +z forward, +x right, +y down)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, down, fwd, eye
    return m


def render_depth_maps(xyz, rgb, seg, intrinsics, cam2world, hw):
    """Z-buffer a point set into per-camera depth/rgb/seg images (numpy).

    xyz [N, 3] world, rgb [N, 3] uint8, seg [N, K] bool;
    intrinsics [C, 3, 3], cam2world [C, 4, 4]; hw = (H, W).
    Returns depth [C, H, W] (0 where empty), rgb [C, H, W, 3],
    seg [C, H, W, K].
    """
    H, W = hw
    C = len(cam2world)
    depth = np.zeros((C, H, W), np.float32)
    rgb_img = np.zeros((C, H, W, 3), np.uint8)
    seg_img = np.zeros((C, H, W, seg.shape[1]), bool)
    for c in range(C):
        world2cam = np.linalg.inv(cam2world[c])
        pc = xyz @ world2cam[:3, :3].T + world2cam[:3, 3]
        z = pc[:, 2]
        front = z > 1e-4
        uvw = pc[front] @ intrinsics[c].T
        u = (uvw[:, 0] / uvw[:, 2]).astype(np.int64)
        v = (uvw[:, 1] / uvw[:, 2]).astype(np.int64)
        zf = z[front]
        inside = (u >= 0) & (u < W) & (v >= 0) & (v < H)
        u, v, zf = u[inside], v[inside], zf[inside]
        src = np.nonzero(front)[0][inside]
        # nearest point wins each pixel: sort far->near so the final write
        # per pixel is the closest
        order = np.argsort(-zf)
        u, v, zf, src = u[order], v[order], zf[order], src[order]
        depth[c, v, u] = zf
        rgb_img[c, v, u] = rgb[src]
        seg_img[c, v, u] = seg[src]
    return depth, rgb_img, seg_img


def fuse_depth_maps(depth, rgb_img, seg_img, intrinsics, cam2world):
    """Unproject + fuse per-camera images into one world cloud (numpy mirror
    of ``ops/camera.py::fuse_camera_pointclouds``; tested equal)."""
    C, H, W = depth.shape
    v, u = np.indices((H, W))
    uv1 = np.stack([u + 0.5, v + 0.5, np.ones_like(u)], -1).astype(np.float64)  # [H, W, 3]
    pts, cols, segs = [], [], []
    for c in range(C):
        mask = depth[c] > 0
        rays = uv1[mask] @ np.linalg.inv(intrinsics[c]).T
        cam_xyz = rays * depth[c][mask][:, None]
        world = cam_xyz @ cam2world[c, :3, :3].T + cam2world[c, :3, 3]
        pts.append(world)
        cols.append(rgb_img[c][mask])
        segs.append(seg_img[c][mask])
    return (np.concatenate(pts).astype(np.float32), np.concatenate(cols),
            np.concatenate(segs))


class FakeManipulationEnv(Env):
    def __init__(
        self,
        obs_mode: str = "pointcloud",
        n_raw_points: int = 4000,
        n_points: int = 1200,
        state_dim: int = 32,
        action_dim: int = 8,
        horizon: int = 50,
        ego_mode: bool = False,
        image_size=(50, 125),
        obs_source: str = "points",  # "points" | "cameras"
        camera_hw=(32, 40),
        keep_good_steps_threshold: int = 1,
        reward_type: str = "dense",
        **kwargs,  # accept & ignore ManiSkill flags (no_early_stop, ...)
    ):
        self.obs_mode = obs_mode
        self.n_raw = n_raw_points
        self.n_points = n_points
        self.state_dim = state_dim
        self.horizon = horizon
        self.ego_mode = ego_mode
        self.image_size = tuple(image_size)
        self.obs_source = obs_source
        self.camera_hw = tuple(camera_hw)
        self.keep_good_steps_threshold = int(keep_good_steps_threshold)
        self.keep_good_steps = defaultdict(int)
        self.reward_type = reward_type
        self.action_space = Box(-1.0, 1.0, (action_dim,))
        self.np_random = np.random.RandomState()
        self._step = 0
        # three cameras around the workspace (reference robot carries three,
        # camera.py:64): fovy ~ pi/3 over a small image
        H, W = self.camera_hw
        f = 0.5 * H / np.tan(np.pi / 6)
        self._intrinsics = np.stack([np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])] * 3)
        self._cam2world = np.stack([
            _look_at([1.2, 0.0, 0.9], [0, 0, 0.2]),
            _look_at([-0.6, 1.0, 0.9], [0, 0, 0.2]),
            _look_at([-0.6, -1.0, 0.9], [0, 0, 0.2]),
        ])

    def seed(self, seed):
        self.np_random.seed(seed)
        self.action_space.seed(seed)

    def reset(self, level: Optional[int] = None, **kwargs):
        if level is not None:
            self.np_random.seed(int(level))
        self._step = 0
        self.keep_good_steps = defaultdict(int)
        self.obj_pos = self.np_random.uniform([-0.4, -0.4, 0.1], [0.4, 0.4, 0.4]).astype(np.float32)
        self.ee_pos = self.np_random.uniform([-0.4, -0.4, 0.2], [0.4, 0.4, 0.6]).astype(np.float32)
        # mobile-base state for the ego transform: xy position + heading
        self.base_orientation = float(self.np_random.uniform(-np.pi, np.pi))
        return self.get_obs()

    @property
    def base_pos(self):
        return self.ee_pos[:2]

    def _cloud(self):
        rs = self.np_random
        n_table = self.n_raw // 2
        n_obj = self.n_raw // 4
        n_robot = self.n_raw - n_table - n_obj
        table = np.stack([rs.uniform(-1, 1, n_table), rs.uniform(-1, 1, n_table), np.zeros(n_table)], -1)
        obj = self.obj_pos + rs.randn(n_obj, 3).astype(np.float32) * 0.03
        robot = self.ee_pos + rs.randn(n_robot, 3).astype(np.float32) * 0.04
        xyz = np.concatenate([table, obj, robot]).astype(np.float32)
        rgb = np.zeros((self.n_raw, 3), np.uint8)
        rgb[:n_table] = (120, 120, 120)
        rgb[n_table : n_table + n_obj] = (200, 40, 40)
        rgb[n_table + n_obj :] = (40, 40, 200)
        seg = np.zeros((self.n_raw, 2), bool)
        seg[n_table : n_table + n_obj, 0] = True  # object
        seg[n_table + n_obj :, 1] = True  # robot
        return xyz, rgb, seg

    def _camera_cloud(self):
        """Render the scene through three cameras and fuse (the reference's
        fused-pointcloud render mode, camera.py:64-109)."""
        xyz, rgb, seg = self._cloud()
        depth, rgb_img, seg_img = render_depth_maps(
            xyz, rgb, seg, self._intrinsics, self._cam2world, self.camera_hw
        )
        return fuse_depth_maps(depth, rgb_img, seg_img, self._intrinsics, self._cam2world)

    def _state(self):
        s = np.zeros(self.state_dim, np.float32)
        s[:3] = self.ee_pos
        s[3:6] = self.obj_pos - self.ee_pos
        s[6] = self._step / max(self.horizon, 1)
        return s

    def _apply_ego_mode(self, xyz):
        """base_env.py:1199-1212: shift xy into the base frame, then rotate
        by -base_orientation about z."""
        ang = -self.base_orientation
        c, s = np.cos(ang), np.sin(ang)
        mat = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
        xyz = xyz.copy()
        xyz[..., :2] -= self.base_pos
        return xyz @ mat.T

    def get_obs(self):
        if self.obs_mode == "state":
            return self._state()
        if self.obs_source == "cameras":
            xyz, rgb, seg = self._camera_cloud()
        else:
            xyz, rgb, seg = self._cloud()
        if self.ego_mode:
            xyz = self._apply_ego_mode(xyz)
        obs = {"xyz": xyz, "rgb": rgb, "seg": seg}
        # budget ratios follow pcd_base defaults (1200/50/800) scaled to n_points
        obs = pcd_base(
            obs,
            n_points=self.n_points,
            min_pts=max(self.n_points // 24, 1),
            fg_pts=self.n_points * 2 // 3,
            np_random=self.np_random,
        )
        out = {
            "xyz": np.ascontiguousarray(obs["xyz"].T.astype(np.float32)),
            "rgb": np.ascontiguousarray(obs["rgb"].T),
            "seg": np.ascontiguousarray(obs["seg"].T.astype(np.float32)),
            "state": self._state(),
        }
        return out

    def _eval(self):
        """Hysteresis eval flags (base_env.py:795-807)."""
        dist = float(np.linalg.norm(self.ee_pos - self.obj_pos))
        flags = {"success": dist < 0.05}
        result = {}
        for key, value in flags.items():
            self.keep_good_steps[key] = self.keep_good_steps[key] + 1 if value else 0
            result[key] = self.keep_good_steps[key] >= self.keep_good_steps_threshold
        return result, result["success"]

    def step(self, action):
        action = np.clip(np.asarray(action, np.float32), -1, 1)
        self.ee_pos = np.clip(self.ee_pos + action[:3] * 0.05, [-1, -1, 0.0], [1, 1, 1])
        self._step += 1
        eval_info, success = self._eval()
        if self.reward_type == "sparse":
            reward = float(success)
        else:
            reward = -float(np.linalg.norm(self.ee_pos - self.obj_pos))
        done = bool(success or self._step >= self.horizon)
        info = {"success": success, "eval_info": eval_info}
        if done and not success:
            info["TimeLimit.truncated"] = True
        return self.get_obs(), reward, done, info

    def render(self, mode="rgb_array", **kwargs):
        h, w = self.image_size
        img = np.full((h, w, 3), 255, np.uint8)
        for pos, color in ((self.obj_pos, (200, 40, 40)), (self.ee_pos, (40, 40, 200))):
            r = int((pos[1] + 1) / 2 * (h - 1))
            c = int((pos[0] + 1) / 2 * (w - 1))
            img[max(r - 1, 0) : r + 2, max(c - 1, 0) : c + 2] = color
        return img

    def get_env_state(self):
        return {"ee_pos": self.ee_pos.copy(), "obj_pos": self.obj_pos.copy(), "step": self._step}
