"""Seeded stand-ins for the simulators the card's machine lacks.

A copy of ``chip_smoke.py``'s ``WalkerRawStandIn`` (with its wrapper chain
``build_walker_standin``), unchanged in what it renders, so the benchmark
generates its own traffic: it ships what dm_control's walker ships in
``obs_mode="raw"`` (depth, rgb and the camera row), ray-cast with numpy
from a procedural scene that the actions move.  It renders the same
frames as ``chip_smoke.py``'s, with what does not change from frame to
frame worked out once and the spheres cast only inside the rectangle of
pixels that their silhouettes can cover: the env workers are threads
that share one interpreter lock, and a render of many small numpy calls
on every pixel held them long enough that the loop cell's pace followed
the host's load rather than the port's.  Its draws come from its
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
    CAM_Y, CAM_Z = -2.2, 1.2  # the camera's place behind and above the torso, which it tracks in x

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
        self._focal, self._centre = focal, c
        self._a = (self._dirs * self._dirs).sum(-1)
        # the camera's height is fixed, so the ground's depth and what each pixel hits without the body are too
        d = self._dirs
        down = d[:, 2] < 0
        t = np.where(down, -self.CAM_Z / np.where(down, d[:, 2], -1.0), np.inf)
        self._depth0 = np.where(down, t, 10.0)
        self._hit0 = np.where(down, 0, -1)
        # a ground pixel's world x less the camera's and its checker row, from the f32 depth that get_obs sees
        d32 = self._depth0.astype(np.float32).astype(np.float64)
        self._ground_dx = d[:, 0] * d32
        self._ground_row = np.floor((self.CAM_Y + d[:, 1] * d32) * 4)
        self._pixels = np.arange(h * w).reshape(h, w)
        self._palette = np.concatenate([[self.SKY], self.GROUND, self.body_colors()]).astype(np.uint8).T.copy()
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

    def _window(self, rel: np.ndarray) -> np.ndarray:
        """The pixels whose rays can meet a sphere: the rectangle that bounds
        the spheres' silhouettes (their tangent planes through the camera),
        widened by two pixels; every pixel where a sphere is not wholly in
        front of the camera.  ``rel`` is ``[8, 3]``, the centres less the
        camera's place."""
        w, h = int(self.image_size[0]), int(self.image_size[1])
        q = rel @ self.cam_rot  # camera coordinates: x right, y down, z ahead
        r = self.SPHERES[:, 2]
        X, Y, Z = q[:, 0], q[:, 1], q[:, 2]
        if np.any(Z <= 1.01 * r):
            return self._pixels.reshape(-1)
        den = Z * Z - r * r
        lo, hi = [], []
        for P, c in ((X, self._centre[0]), (Y, self._centre[1])):
            root = r * np.sqrt(P * P + Z * Z - r * r)
            lo.append(self._focal * ((P * Z - root) / den).min() + c - 0.5)
            hi.append(self._focal * ((P * Z + root) / den).max() + c - 0.5)
        u0, v0 = max(int(np.floor(lo[0])) - 2, 0), max(int(np.floor(lo[1])) - 2, 0)
        u1, v1 = min(int(np.ceil(hi[0])) + 3, w), min(int(np.ceil(hi[1])) + 3, h)
        return self._pixels[v0:v1, u0:u1].reshape(-1)

    def render_ids(self):
        """Depth per pixel and what it hit: -1 sky, 0 ground, 1 + sphere."""
        cam = np.array([self.x, self.CAM_Y, self.CAM_Z])
        depth, hit = self._depth0.copy(), self._hit0.copy()
        centres = np.stack([self.x + self.SPHERES[:, 0] + self.pose[:, 0], np.zeros(8),
                            self.SPHERES[:, 1] + self.pose[:, 1]], -1)
        win = self._window(centres - cam)
        if len(win):
            d, a = self._dirs[win], self._a[win, None]
            oc = cam - centres
            b = np.stack([d @ o for o in oc], -1)
            c = np.array([o @ o for o in oc]) - self.SPHERES[:, 2] ** 2
            disc = b * b - a * c
            tt = (-b - np.sqrt(np.maximum(disc, 0.0))) / a
            tt = np.where((disc > 0) & (tt > 0), tt, np.inf)
            first = tt.argmin(-1)  # the nearest sphere, the first of equals, as spheres cast in turn keep it
            t = tt[np.arange(len(win)), first]
            near = t < depth[win]
            depth[win[near]], hit[win[near]] = t[near], first[near] + 1
        h, w = int(self.image_size[1]), int(self.image_size[0])
        return depth.reshape(h, w).astype(np.float32), hit.reshape(h, w), cam

    def get_obs(self):
        depth, hit, cam = self.render_ids()
        h, w = depth.shape
        hit = hit.reshape(-1)
        colour = np.where(hit > 0, hit + 2, 0)  # sky 0, the ground's two squares 1 and 2, sphere i 2 + i
        ground = np.flatnonzero(hit == 0)
        checker = (np.floor((self.x + self._ground_dx[ground]) * 4) + self._ground_row[ground]) % 2
        colour[ground] = np.where(checker > 0, 1, 2)
        rgb = self._palette[:, colour].reshape(3, h, w)
        cm = np.zeros(12, np.float32)
        cm[:9] = self.cam_rot.reshape(-1)
        cm[9] = cam[2]
        return {"depth": depth[None], "rgb": rgb, "cam": cm.reshape(1, 1, 12)}

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
