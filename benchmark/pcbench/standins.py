"""Seeded stand-ins for the simulators the card's machine lacks.

A copy of ``chip_smoke.py``'s ``WalkerRawStandIn`` (with its wrapper chain
``build_walker_standin``), unchanged in what it renders, so the benchmark
generates its own traffic: it ships what dm_control's walker ships in
``obs_mode="raw"`` (depth, rgb and the camera row), ray-cast with numpy
from a procedural scene that the actions move.  Its draws come from its
own ``RandomState``, seeded by the rollout's base seed plus the worker
index.  Of ``chip_smoke.py``'s ``ManiSkillRawStandIn`` only the shape of its
cloud is kept, for the ManiSkill fill: no cell runs ManiSkill envs.
"""

from __future__ import annotations

import numpy as np

WALKER_EPISODE_LENGTH = 1000


class WalkerRawStandIn:
    """A raw-render stand-in for ``dmc_walker_walk`` in ``obs_mode="raw"``:
    depth ``[1, H, W]`` f32, rgb ``[3, H, W]`` u8 and the camera row ``[1, 1,
    12]``, ray-cast from the ground plane z = 0 seen from a camera pitched 25
    degrees down that tracks the body, a body of eight spheres that the
    actions and a seeded jitter move, and sky beyond ``max_depth``."""

    SPHERES = np.array([  # x, z offsets from the torso, radius
        [0.0, 1.15, 0.20], [0.0, 0.85, 0.16], [-0.10, 0.58, 0.11], [0.10, 0.58, 0.11],
        [-0.12, 0.30, 0.09], [0.12, 0.30, 0.09], [-0.14, 0.07, 0.07], [0.14, 0.07, 0.07]], np.float64)
    SKY = (120, 170, 230)
    GROUND = ((90, 110, 90), (60, 80, 60))
    Z_TO_WORLD = True  # the camera row carries the camera's height, added to each point's

    def __init__(self, obs_mode="raw", image_size=(84, 84), n_points=512, num_ground=128, ground_eps=8e-3,
                 max_depth=5.0, fovy=45.0, frame_skip=2, **kwargs):
        from pointcloud_rl_torch.env.spaces import Box

        assert obs_mode == "raw", obs_mode
        self.obs_mode = obs_mode
        self.image_size = np.asarray(image_size)
        self.n_points, self.num_ground, self.ground_eps = n_points, num_ground, ground_eps
        self.max_depth, self.frame_skip = max_depth, frame_skip
        self.z_to_world, self.fix_base_z = self.Z_TO_WORLD, None
        self.action_space = Box(-np.ones(6, np.float32), np.ones(6, np.float32))
        w, h = int(self.image_size[0]), int(self.image_size[1])
        focal = 0.5 * h / np.tan(fovy * np.pi / 360.0)
        c = (self.image_size - 1) / 2.0
        self.inv_intrinsic = np.linalg.inv(np.array([[focal, 0, c[0]], [0, focal, c[1]], [0, 0, 1.0]]))
        pitch = np.deg2rad(25.0)
        fwd = np.array([0.0, np.cos(pitch), -np.sin(pitch)])
        right = np.array([1.0, 0.0, 0.0])
        self.cam_rot = np.stack([right, np.cross(fwd, right), fwd], axis=1)  # OpenCV camera -> world
        v, u = np.indices((h, w))
        uv1 = np.stack([u + 0.5, v + 0.5, np.ones((h, w))], -1).reshape(-1, 3)
        self._dirs = uv1 @ self.inv_intrinsic.T @ self.cam_rot.T  # world direction per unit depth
        self.rs = np.random.RandomState(0)

    @classmethod
    def body_colors(cls) -> np.ndarray:
        """``[8, 3]`` u8: the colour of each sphere."""
        hit = np.arange(1, 9)
        return np.stack([200 - 10 * hit, 120 + 5 * hit, 60 + 0 * hit], -1).astype(np.uint8)

    def seed(self, seed):
        self.rs = np.random.RandomState(seed)
        self.action_space.seed(seed)

    def reset(self, **kwargs):
        self.x = 0.0
        self.pose = self.rs.uniform(-0.03, 0.03, (8, 2))
        return self.get_obs()

    def step(self, action):
        a = np.clip(np.asarray(action, np.float64), -1, 1)
        x0 = self.x
        for _ in range(self.frame_skip):
            self.x += 0.01 * (1.0 + a[0])
            self.pose = 0.9 * self.pose + 0.02 * np.repeat(a[1:5], 2)[:8, None] + self.rs.normal(0, 0.01, (8, 2))
        reward = 10.0 * (self.x - x0) - 1e-3 * float(a @ a)
        return self.get_obs(), reward, False, {}

    def render_ids(self):
        """Depth per pixel and what it hit: -1 sky, 0 ground, 1 + sphere."""
        cam = np.array([self.x, -2.2, 1.2])
        d = self._dirs
        depth = np.full(len(d), 10.0)
        hit = np.full(len(d), -1)
        down = d[:, 2] < 0
        t = np.where(down, -cam[2] / np.where(down, d[:, 2], -1.0), np.inf)
        depth = np.where(down, t, depth)
        hit[down] = 0
        centres = np.stack([self.x + self.SPHERES[:, 0] + self.pose[:, 0], np.zeros(8),
                            self.SPHERES[:, 1] + self.pose[:, 1]], -1)
        a = (d * d).sum(-1)
        for i, (c, r) in enumerate(zip(centres, self.SPHERES[:, 2])):
            oc = cam - c
            b = d @ oc
            disc = b * b - a * (oc @ oc - r * r)
            tt = (-b - np.sqrt(np.maximum(disc, 0.0))) / a
            near = (disc > 0) & (tt > 0) & (tt < depth)
            depth[near], hit[near] = tt[near], i + 1
        h, w = int(self.image_size[1]), int(self.image_size[0])
        return depth.reshape(h, w).astype(np.float32), hit.reshape(h, w), cam

    def get_obs(self):
        depth, hit, cam = self.render_ids()
        h, w = depth.shape
        world = cam + self._dirs * depth.reshape(-1, 1)
        checker = ((np.floor(world[:, 0] * 4) + np.floor(world[:, 1] * 4)) % 2).reshape(h, w)
        rgb = np.empty((h, w, 3), np.uint8)
        rgb[:] = self.SKY
        ground = hit == 0
        rgb[ground] = np.where(checker[ground, None] > 0, self.GROUND[0], self.GROUND[1])
        body = hit > 0
        rgb[body] = np.stack([200 - 10 * hit[body], 120 + 5 * hit[body], 60 + 0 * hit[body]], -1)
        cm = np.zeros(12, np.float32)
        cm[:9] = self.cam_rot.reshape(-1)
        cm[9] = cam[2]
        return {"depth": depth[None], "rgb": np.ascontiguousarray(rgb.transpose(2, 0, 1)), "cam": cm.reshape(1, 1, 12)}

    def render(self, mode="rgb_array", **kwargs):
        return self.get_obs()["rgb"].transpose(1, 2, 0)

    def close(self):
        pass


def build_walker_standin(obs_mode="raw", stack_frame=1, horizon=None, frame_skip=2, **kwargs):
    """The wrapper chain the port's ``make_gym_env`` builds, around the stand-in."""
    from pointcloud_rl_torch.env.api import ExtendedEnv, FrameStackWrapper, TimeLimit

    env = WalkerRawStandIn(obs_mode=obs_mode, frame_skip=frame_skip, **kwargs)
    if stack_frame > 1:
        env = FrameStackWrapper(env, stack_frame)
    env = TimeLimit(env, horizon or (WALKER_EPISODE_LENGTH + frame_skip - 1) // frame_skip)
    env = ExtendedEnv(env)
    env.obs_mode = obs_mode
    return env


def register_walker() -> str:
    """Register ``build_walker_standin`` in the port's env registry; returns its type name."""
    from pointcloud_rl_torch.env.builder import ENVS

    if "WalkerRawStandIn" not in ENVS:
        ENVS.register_module(name="WalkerRawStandIn", module=build_walker_standin)
    return "WalkerRawStandIn"


# The ManiSkill stand-in's cloud (``ManiSkillRawStandIn``), which the
# updates traffic's fill follows: the points of its three segments (a
# handle, the object, the robot) and the colours of the ground, the
# segments and the background.
MANISKILL_SEGMENTS = (300, 600, 1100)
MANISKILL_COLORS = ((0.4, 0.4, 0.4), (0.9, 0.8, 0.1), (0.6, 0.3, 0.1), (0.2, 0.4, 0.9), (0.7, 0.7, 0.7))
