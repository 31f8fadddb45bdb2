# Copy of pointcloud_rl_tpu/env/dmc.py for the PyTorch port (that package's env imports JAX).
"""DM Control integration: depth -> point-cloud observation pipeline.

Parity target: reference ``pyrl/env/external_envs/dm_control_utils.py`` —
per-domain frame-skip / depth-filter / ground-eps / point-count tables,
camera intrinsics from MuJoCo fovy, depth unprojection into the camera frame
rotated to world orientation (z shifted to world height), ground/body split
sampling with pad-by-tiling, and rgb/rgbd modes; actions are rescaled from
[-1, 1] to the env's bounds; TimeLimit of episode_length // frame_skip.

Requires MUJOCO_GL=egl (set by utils.seeding.add_env_vars).
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Optional, Tuple

import numpy as np

# Must be set before dm_control/mujoco load their GL backend (headless EGL).
os.environ.setdefault("MUJOCO_GL", "egl")

from .api import Env, TimeLimit
from .obs_process import sample_and_pad
from .spaces import Box

# Per-domain tables (reference dm_control_utils.py:33-66).
DEFAULT_ACTION_REPEAT = defaultdict(lambda: 4)
DEFAULT_ACTION_REPEAT.update({"humanoid": 2, "dog": 2, "walker": 2, "finger": 2, "cartpole": 4, "reacher3d": 1})

DEFAULT_DEPTH_FILTER = defaultdict(lambda: 5)
DEFAULT_DEPTH_FILTER.update({"acrobot": 10, "dog": 10, "humanoid": 8, "reacher3d": 20})

DEFAULT_GROUND_EPS = defaultdict(lambda: 8e-3)
DEFAULT_GROUND_EPS.update({"acrobot": 0.02, "dog": 0.02, "humanoid": 0.02, "cartpole": 0.01, "reacher3d": 0.1})

DEFAULT_NUM_BODY = {
    "ball_in_cup": 128, "cartpole": 256, "reacher": 256, "finger": 384, "walker": 384,
    "cheetah": 256, "quadruped": 384, "acrobot": 128, "hopper": 256, "humanoid": 384,
    "dog": 384, "reacher3d": 128,
}


def _flatten_state(observation) -> np.ndarray:
    pieces = []
    for v in observation.values():
        pieces.append(np.asarray([v]) if np.isscalar(v) else np.asarray(v).ravel())
    return np.concatenate(pieces).astype(np.float32)


class DMCEnv(Env):
    """Wraps a dm_control suite env with visual observation modes."""

    def __init__(
        self,
        env,
        obs_mode: str = "state",
        image_size: Tuple[int, int] = (84, 84),
        frame_skip: int = 4,
        max_depth: float = 5.0,
        n_points: int = 512,
        num_ground: int = 100,
        ground_eps: float = 8e-3,
        camera_id: int = 0,
        z_to_world: bool = True,
        fix_base_z: Optional[float] = None,
        use_native: bool = True,
        fast_render: bool = True,
    ):
        assert obs_mode in ("state", "rgb", "rgbd", "depth", "pointcloud", "xyz-img", "raw")
        self.env = env
        self.obs_mode = obs_mode
        self.image_size = np.asarray(image_size)
        self.frame_skip = frame_skip
        self.max_depth = max_depth
        self.n_points = n_points
        self.num_ground = num_ground
        self.ground_eps = ground_eps
        self.camera_id = camera_id
        self.z_to_world = z_to_world
        self.fix_base_z = fix_base_z
        from ..native import available as native_available

        self.use_native = bool(use_native) and native_available()
        # fast_render disables shadow/reflection/skybox passes — fewer
        # software-GL passes and no shadow-shader compilation on cold
        # caches. Geometry (depth/xyz) is identical; rgb loses shadow
        # shading relative to the reference's default renderer. Set
        # fast_render=False for exact visual parity.
        self.fast_render = bool(fast_render)
        if self.fast_render:
            # Offscreen MSAA (MuJoCo default offsamples=4) rasterizes 4
            # samples/pixel — ~2x the whole env-step cost on software GL —
            # and the resolve AVERAGES depth across samples, planting
            # phantom points between foreground and background at
            # silhouettes.  Single-sample is both faster and geometrically
            # correct for depth->pointcloud.  Must run before the first
            # render (the GL context bakes the sample count in).
            env.physics.model.vis.quality.offsamples = 0

        spec = env.action_spec()
        self.min_action = np.float32(spec.minimum)
        self.max_action = np.float32(spec.maximum)
        self.action_space = Box(-np.ones_like(self.min_action), np.ones_like(self.min_action))

    # -------------------------------------------------------------- camera
    @property
    def physics(self):
        return self.env.physics

    @property
    def np_random(self) -> np.random.RandomState:
        return self.env.task._random

    @property
    def inv_intrinsic(self) -> np.ndarray:
        """Inverse pinhole intrinsics from the MuJoCo camera fovy."""
        fov = self.physics.model.cam_fovy[self.camera_id]
        focal = 0.5 * self.image_size[1] / np.tan(fov * np.pi / 360.0)
        c = (self.image_size - 1) / 2.0
        k = np.array([[focal, 0, c[0]], [0, focal, c[1]], [0, 0, 1.0]])
        return np.linalg.inv(k)

    def get_cam_pose(self) -> Tuple[np.ndarray, np.ndarray]:
        """Camera position and camera->world rotation.  MuJoCo's cam_mat0 is
        the body-frame orientation; the extra flip matches the render
        convention (reference dm_control_utils.py:256-261)."""
        pos = self.physics.data.cam_xpos[self.camera_id]
        cam_to_body = np.array(self.physics.model.cam_mat0[self.camera_id]).reshape(3, 3)
        flip = np.diag([1.0, -1.0, -1.0])
        return pos, cam_to_body @ flip

    def _unproject(self, depth: np.ndarray) -> np.ndarray:
        v, u = np.indices(depth.shape)
        uv1 = np.stack([u + 0.5, v + 0.5, np.ones_like(depth)], axis=-1)
        return uv1 @ self.inv_intrinsic.T * depth[..., None]

    def _render(self, with_depth: bool):
        w, h = int(self.image_size[0]), int(self.image_size[1])
        if not with_depth:
            overrides = {"shadow": False, "reflection": False, "skybox": False} if self.fast_render else None
            rgb = self.physics.render(height=h, width=w, camera_id=self.camera_id,
                                      render_flag_overrides=overrides)
            return rgb, None, None
        # Single-pass rgb+depth: mjr_readPixels fills BOTH buffers from one
        # mjr_render.  dm_control's Camera.render does a full scene render
        # per output, which doubles the cost on software EGL — the env-step
        # bottleneck on GPU-less hosts.
        rgb, depth = self._dual_render(w, h)
        return rgb, depth, depth <= self.max_depth

    def _dual_render(self, w: int, h: int):
        import mujoco
        from dm_control.mujoco.engine import Camera

        cam = getattr(self, "_cached_camera", None)
        if cam is None or cam._physics is not self.physics:
            cam = Camera(self.physics, height=h, width=w, camera_id=self.camera_id)
            if self.fast_render:
                for flag in (mujoco.mjtRndFlag.mjRND_SHADOW, mujoco.mjtRndFlag.mjRND_REFLECTION,
                             mujoco.mjtRndFlag.mjRND_SKYBOX):
                    cam._scene.flags[flag] = 0
            self._cached_camera = cam
        cam.update()
        ctx_mujoco = self.physics.contexts.mujoco

        def _render_and_read():
            mujoco.mjr_render(cam._rect, cam._scene.ptr, ctx_mujoco.ptr)
            mujoco.mjr_readPixels(cam._rgb_buffer, cam._depth_buffer, cam._rect, ctx_mujoco.ptr)

        with self.physics.contexts.gl.make_current() as ctx:
            ctx.call(_render_and_read)
        # Depth buffer -> meters (znear/zfar convention, as dm_control does),
        # and flip: the buffer's first row is the bottom pixel row.
        extent = self.physics.model.stat.extent
        near = self.physics.model.vis.map.znear * extent
        far = self.physics.model.vis.map.zfar * extent
        depth = near / (1.0 - cam._depth_buffer * (1.0 - near / far))
        return np.flipud(cam._rgb_buffer).copy(), np.flipud(depth).copy()

    # ----------------------------------------------------------------- obs
    def get_obs(self, time_step=None):
        if self.obs_mode == "state":
            return _flatten_state(time_step.observation) if time_step is not None else _flatten_state(
                self.env.task.get_observation(self.physics)
            )
        with_depth = self.obs_mode in ("depth", "rgbd", "pointcloud", "xyz-img", "raw")
        rgb, depth, sign = self._render(with_depth)
        if self.obs_mode == "raw":
            # Server-render analogue (reference vec_env.py:562-742): ship the
            # raw render products; the batched device program in
            # ops/obs_fuse.py unprojects + samples for the whole vec batch.
            cam_pos, cam_rot = self.get_cam_pose()
            cm = np.zeros(12, np.float32)
            cm[:9] = cam_rot.reshape(-1)
            cm[9] = cam_pos[-1]
            return {
                "depth": depth[None].astype(np.float32),           # [1, H, W]
                "rgb": np.ascontiguousarray(rgb.transpose(2, 0, 1)),  # [3, H, W]
                "cam": cm.reshape(1, 1, 12),                       # [1, 1, 12]
            }
        obs = {}
        if self.obs_mode in ("pointcloud", "xyz-img"):
            cam_pos, cam_rot = self.get_cam_pose()
            if self.obs_mode == "pointcloud" and self.use_native and self.num_ground >= 0:
                return self._native_pointcloud_obs(rgb, depth, sign, cam_pos, cam_rot)
            xyz = self._unproject(depth) @ cam_rot.T  # world-oriented, camera-centered
            if self.z_to_world:
                xyz[..., -1] += cam_pos[-1]
            if self.obs_mode == "pointcloud":
                assert not np.isnan(depth).any(), "Depth contains nan values"
                xyz, rgb_pts = xyz[sign], rgb[sign]
                if xyz.shape[0] == 0:
                    xyz = np.zeros([self.n_points, 3], np.float32)
                    rgb_pts = np.zeros([self.n_points, 3], np.uint8)
                    if self.num_ground == -1:
                        obs["filter_seg"] = np.zeros([self.n_points, 1], np.uint8)
                elif self.num_ground == -1:
                    # No ground/body budget split: random-permute (pad by
                    # tiling) to n_points and emit the foreground mask as a
                    # ``filter_seg`` channel for a downstream seg-aware
                    # downsample aug (reference dm_control_utils.py:407-421;
                    # consumed by ops/augment.RandomDownSampleAndFilter).
                    base_z = xyz[..., -1].min() if self.fix_base_z is None else self.fix_base_z
                    ground = xyz[..., -1] <= base_z + self.ground_eps
                    len_xyz = len(xyz)
                    if len_xyz < self.n_points:
                        index = np.arange(len_xyz)
                        index = np.concatenate([index] * ((self.n_points + len_xyz - 1) // len_xyz))
                    else:
                        index = self.np_random.permutation(len_xyz)
                    index = index[: self.n_points]
                    xyz, rgb_pts = xyz[index], rgb_pts[index]
                    obs["filter_seg"] = (~ground[index])[:, None].astype(np.uint8)
                else:
                    base_z = xyz[..., -1].min() if self.fix_base_z is None else self.fix_base_z
                    ground = xyz[..., -1] <= base_z + self.ground_eps
                    g_idx, b_idx = np.where(ground)[0], np.where(~ground)[0]
                    n_body = self.n_points - self.num_ground
                    body_sel = sample_and_pad(len(b_idx), n_body, self.np_random)
                    ground_sel = sample_and_pad(len(g_idx), self.num_ground, self.np_random)
                    if len(b_idx) > 0 and len(g_idx) > 0:
                        index = np.concatenate([b_idx[body_sel], g_idx[ground_sel]])
                        xyz, rgb_pts = xyz[index], rgb_pts[index]
                    else:
                        # One side empty: zero-fill that side (dm_control_utils.py:384-402)
                        body_part = b_idx[body_sel] if len(b_idx) > 0 else np.zeros(n_body, np.int64)
                        ground_part = g_idx[ground_sel] if len(g_idx) > 0 else np.zeros(self.num_ground, np.int64)
                        index = np.concatenate([body_part, ground_part])
                        xyz, rgb_pts = xyz[index].copy(), rgb_pts[index].copy()
                        if len(b_idx) == 0:
                            xyz[:n_body] = 0
                            rgb_pts[:n_body] = 0
                        if len(g_idx) == 0:
                            xyz[n_body:] = 0
                            rgb_pts[n_body:] = 0
                obs["xyz"] = xyz.astype(np.float32)
                obs["rgb"] = rgb_pts
            else:
                xyz[~sign] = 0
                obs["xyz"] = xyz.astype(np.float32)
                obs["rgb"] = rgb
        else:
            if "rgb" in self.obs_mode:
                obs["rgb"] = rgb
            if "d" in self.obs_mode:  # rgbd / depth
                d = depth.copy()
                d[~sign] = 0
                obs["depth"] = np.float32(d / self.max_depth)[..., None]
        # channel-first env contract
        out = {}
        for k, v in obs.items():
            if v.ndim == 3:
                out[k] = np.ascontiguousarray(v.transpose(2, 0, 1))
            elif v.ndim == 2:
                out[k] = np.ascontiguousarray(v.T)
            else:
                out[k] = v
        return out

    def _native_pointcloud_obs(self, rgb, depth, sign, cam_pos, cam_rot):
        """C++ fast path: unproject + ground/body split sample in one pass
        (csrc/pcrl_native.cpp); deterministic via the env's RNG stream."""
        from .. import native

        z_off = float(cam_pos[-1]) if self.z_to_world else 0.0
        xyz_img = native.unproject_depth(depth, self.inv_intrinsic, cam_rot, z_off)
        seed = int(self.np_random.randint(2**31))
        out_xyz, out_rgb, _ = native.ground_body_split_sample(
            xyz_img.reshape(-1, 3),
            np.ascontiguousarray(rgb.reshape(-1, 3)),
            sign.reshape(-1).astype(np.uint8),
            float(self.ground_eps),
            self.n_points - self.num_ground,
            self.num_ground,
            seed,
            fix_base_z=self.fix_base_z,
        )
        return {"xyz": np.ascontiguousarray(out_xyz.T), "rgb": np.ascontiguousarray(out_rgb.T)}

    # ---------------------------------------------------------------- step
    def seed(self, seed):
        self.np_random.seed(seed)
        self.action_space.seed(seed)

    def step(self, action):
        # [-1, 1] -> [min_action, max_action] (dm_control_utils.py:471-473)
        a = np.clip((np.asarray(action) + 1.0) * 0.5, 0.0, 1.0)
        a = self.max_action * a + self.min_action * (1.0 - a)
        reward = 0.0
        time_step = None
        done = False
        for _ in range(self.frame_skip):
            time_step = self.env.step(a)
            reward += time_step.reward or 0.0
            done = time_step.last()
            if done:
                break
        obs = self.get_obs(time_step)
        if done and time_step.discount > 0.9:
            done = False  # time-limit truncation, not termination
        return obs, reward, done, {}

    def reset(self, **kwargs):
        time_step = self.env.reset()
        return self.get_obs(time_step)

    def render(self, mode="rgb_array", **kwargs):
        return self.physics.render(
            height=int(self.image_size[1]), width=int(self.image_size[0]), camera_id=self.camera_id
        )

    def close(self):
        self.env.close()
        # Free the EGL render context from THIS thread: contexts are
        # thread-affine, and leaving them to dm_control's atexit hook frees
        # them from the main thread (EGL_BAD_ACCESS spam under the
        # thread-based vec env).
        try:
            physics = getattr(self.env, "physics", None)
            if physics is not None:
                physics.free()
        except Exception:
            pass


def parse_dmc_name(env_name: str):
    """'dmc_cheetah_run-v0' -> (domain, task) honoring multi-word domains."""
    assert env_name.startswith(("dmc_", "distract_dmc_"))
    body = env_name.split("dmc_", 1)[1]
    body = body.rsplit("-v", 1)[0]
    # Domains can contain underscores (ball_in_cup); match against the suite.
    from dm_control import suite

    domains = {d for d, _ in suite.ALL_TASKS}
    parts = body.split("_")
    for cut in range(len(parts) - 1, 0, -1):
        domain = "_".join(parts[:cut])
        if domain in domains:
            return domain, "_".join(parts[cut:])
    raise KeyError(f"Cannot parse dm_control env name {env_name}")


def build_dmc_env(
    env_name: str,
    obs_mode: str = "state",
    image_size=(84, 84),
    camera_id: Optional[int] = None,
    episode_length: int = 1000,
    frame_skip: Optional[int] = None,
    max_depth: Optional[float] = None,
    n_points: Optional[int] = None,
    num_ground: Optional[int] = None,
    ground_eps: Optional[float] = None,
    **kwargs,
) -> Env:
    """Build a DMC env with per-domain defaults (dm_control_utils.py:69-129)."""
    from dm_control import suite

    domain, task = parse_dmc_name(env_name)
    frame_skip = frame_skip if frame_skip is not None else DEFAULT_ACTION_REPEAT[domain]
    max_depth = max_depth if max_depth is not None else DEFAULT_DEPTH_FILTER[domain]
    ground_eps = ground_eps if ground_eps is not None else DEFAULT_GROUND_EPS[domain]
    if n_points is None:
        if num_ground is None:
            n_points = int(DEFAULT_NUM_BODY.get(domain, 384) * 4 / 3)
            num_ground = n_points // 4
        else:
            n_points = int(DEFAULT_NUM_BODY.get(domain, 384)) + num_ground
    if num_ground is None:
        num_ground = 0
    if camera_id is None:
        camera_id = 2 if domain == "quadruped" else 0

    raw = suite.load(domain, task, task_kwargs=kwargs.pop("task_kwargs", None))
    env = DMCEnv(
        raw,
        obs_mode=obs_mode,
        image_size=image_size,
        frame_skip=frame_skip,
        max_depth=max_depth,
        n_points=n_points,
        num_ground=num_ground,
        ground_eps=ground_eps,
        camera_id=camera_id,
    )
    env.domain, env.task_name = domain, task
    max_episode_steps = (episode_length + frame_skip - 1) // frame_skip
    return TimeLimit(env, max_episode_steps=max_episode_steps)
