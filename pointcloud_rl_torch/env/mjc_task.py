# Copy of pointcloud_rl_tpu/env/mjc_task.py for the PyTorch port (that package's env imports JAX).
"""Shared machinery for real-physics manipulation tasks on MuJoCo.

The ManiSkill benchmark's task envs share one BaseEnv (reference
``mani_skill/mani_skill/env/base_env.py``): multi-camera rendering fused
into segmented pointclouds, agent stepping at a control frequency, eval
flags with hysteresis, ego-mode transforms.  This is the MuJoCo-side
equivalent for this repo's task family (MoveBucketMJC, OpenCabinet*MJC,
PushChairMJC): subclasses supply the scene XML, the reward, the eval
flags, and the ``_state()`` vector; everything camera/pointcloud/stepping
lives here.

Cited parity points:
- camera fusion + seg-aware downsample: reference
  ``pyrl/env/wrappers/observation_process.py`` ``pcd_base`` and
  ``maniskill_wrappers.py:142-199``;
- eval-flag hysteresis: reference ``base_env.py:795-807``
  (``keep_good_steps`` over per-flag streaks);
- control loop: reference ``base_env.py:865-873`` (frame_skip control
  steps x sim substeps per env step, normalized actions scaled to the
  agent's action range, base_env.py:808-812).
"""

from __future__ import annotations

from collections import defaultdict
from typing import List, Optional, Tuple

import numpy as np

from .api import Env
from .obs_process import pcd_base


class MujocoTaskEnv(Env):
    """Base class: rendering, fused segmented pointclouds, A2 stepping,
    eval hysteresis.  Subclasses must set (usually in ``__init__``/
    ``reset``): ``obs_mode``, ``n_points``, ``image_hw``, ``horizon``,
    ``max_depth``, ``ego_mode``, ``np_random``, ``agent`` (``A2Robot`` or
    None), ``model``/``data``, ``_seg_geoms`` (list of geom-id sets, one
    per segmentation channel), ``camera_names``; and implement
    ``_state()`` plus their reward/eval logic."""

    camera_names: Tuple[str, ...] = ("cam0", "cam1", "cam2")

    # populated by subclasses
    model = None
    data = None
    agent = None
    _renderers = None
    _seg_geoms: List[set] = []

    def seed(self, seed):
        self.np_random.seed(seed)
        self.action_space.seed(seed)

    # ----------------------------------------------------------- hierarchy
    def _in_subtree(self, body: int, root: int) -> bool:
        m = self.model
        while body != 0:
            if body == root:
                return True
            body = m.body_parentid[body]
        return root == 0

    def _subtree(self, root: int) -> set:
        m = self.model
        out = {root}
        for b in range(m.nbody):
            if m.body_parentid[b] in out and b != root:
                out.add(b)
        return out

    def _geoms_of(self, bodies) -> set:
        m = self.model
        return {g for g in range(m.ngeom) if m.geom_bodyid[g] in bodies}

    # ------------------------------------------------------------ stepping
    def _step_agent(self, action: np.ndarray) -> None:
        """Reference step loop (base_env.py:865-873): ``ctrl_per_step``
        control steps, each ``n_sim_per_control`` sim substeps; the
        normalized action is scaled to the agent range once."""
        import mujoco

        scaled = self.agent.scale_action(action)
        for _ in range(self.ctrl_per_step):
            self.agent.set_action(scaled.copy(), self.ego_mode)
            for _ in range(self.n_sim_per_control):
                self.agent.simulation_step()
                mujoco.mj_step(self.model, self.data)

    # ----------------------------------------------------------- hysteresis
    def _reset_hysteresis(self) -> None:
        self.keep_good_steps = defaultdict(int)

    def _apply_hysteresis(self, flags: dict) -> dict:
        """Per-flag streak counters (reference base_env.py:795-807): a flag
        reports True only after ``keep_good_steps_threshold`` consecutive
        raw-True steps; ``success`` is the AND of the debounced flags."""
        result = {}
        for key, value in flags.items():
            self.keep_good_steps[key] = self.keep_good_steps[key] + 1 if value else 0
            result[key] = bool(self.keep_good_steps[key] >= self.keep_good_steps_threshold)
        result["success"] = all(result.values())
        return result

    # ------------------------------------------------------------ rendering
    def _get_renderers(self):
        import mujoco

        if self._renderers is None:
            H, W = self.image_hw
            self._renderers = mujoco.Renderer(self.model, H, W)
        return self._renderers

    def _camera_params(self, cam_name: str):
        import mujoco

        m, d = self.model, self.data
        cid = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_CAMERA, cam_name)
        H, W = self.image_hw
        fovy = np.deg2rad(m.cam_fovy[cid])
        f = 0.5 * H / np.tan(fovy / 2)
        pos = d.cam_xpos[cid].copy()
        rot = d.cam_xmat[cid].reshape(3, 3).copy()  # cam-to-world, -z forward
        return f, pos, rot

    def _render_camera(self, cam_name: str):
        import mujoco

        ren = self._get_renderers()
        H, W = self.image_hw
        # Single visual pass for rgb AND depth: mjr_readPixels fills both
        # buffers from one mjr_render (same trick as env/dmc.py:_dual_render).
        # Renderer.render() rasterizes the full scene once PER output — with
        # the seg pass that is 3 passes/camera, and rendering is ~80% of the
        # host step cost on this GPU-less image.  Segmentation keeps its own
        # pass (IDCOLOR rasterization draws different colors).
        ren.update_scene(self.data, camera=cam_name)
        if ren._gl_context:
            ren._gl_context.make_current()
        rgb = np.empty((H, W, 3), np.uint8)
        zbuf = np.empty((H, W), np.float32)
        mujoco.mjr_render(ren._rect, ren._scene, ren._mjr_context)
        mujoco.mjr_readPixels(rgb, zbuf, ren._rect, ren._mjr_context)
        # Reversed-Z buffer (the renderer sets readDepthMap=mjDEPTH_ZEROFAR)
        # -> metric depth: invert the OpenGL projection in float64, with the
        # frustum coefficients computed in float32 to match glFrustum.
        extent = self.model.stat.extent
        zfar = np.float32(self.model.vis.map.zfar * extent)
        znear = np.float32(self.model.vis.map.znear * extent)
        c = np.float32(-0.5) * (-(zfar + znear) / (zfar - znear)) - np.float32(0.5)
        d = np.float32(-0.5) * (-(np.float32(2) * zfar * znear) / (zfar - znear))
        depth = (d / (zbuf.astype(np.float64) + c)).astype(np.float32)
        rgb = np.flipud(rgb)  # offscreen buffers are vertically flipped
        depth = np.flipud(depth)
        ren.enable_segmentation_rendering()
        ren.update_scene(self.data, camera=cam_name)
        seg_raw = ren.render()[..., 0].copy()
        ren.disable_segmentation_rendering()
        return rgb, depth, seg_raw

    def _fused_cloud(self):
        H, W = self.image_hw
        v, u = np.indices((H, W))
        pts, cols, segs = [], [], []
        for cam in self.camera_names:
            rgb, depth, seg_raw = self._render_camera(cam)
            f, pos, rot = self._camera_params(cam)
            mask = (depth > 1e-3) & (depth < self.max_depth)
            d = depth[mask]
            # camera frame: x right, y up, looking along -z (MuJoCo render
            # convention); row 0 is the TOP image row
            x = (u[mask] + 0.5 - W / 2) / f * d
            y = (H / 2 - (v[mask] + 0.5)) / f * d
            cam_pts = np.stack([x, y, -d], -1)
            pts.append(cam_pts @ rot.T + pos)
            cols.append(rgb[mask])
            gid = seg_raw[mask]
            seg = np.zeros((len(d), len(self._seg_geoms)), bool)
            for k, geom_set in enumerate(self._seg_geoms):
                if geom_set:
                    seg[:, k] = np.isin(gid, list(geom_set))
            segs.append(seg)
        return np.concatenate(pts).astype(np.float32), np.concatenate(cols), np.concatenate(segs)

    # ----------------------------------------------------------------- obs
    def _state_extras(self) -> List[np.ndarray]:
        """Extra world quantities appended in obs_mode='state' (subclass)."""
        return []

    def get_obs(self):
        if self.obs_mode == "state":
            return np.concatenate(
                [self._state()] + [np.asarray(e).reshape(-1) for e in self._state_extras()]
            ).astype(np.float32)
        xyz, rgb, seg = self._fused_cloud()
        if self.ego_mode:
            xyz = xyz.copy()
            if self.agent is not None:
                # base frame: shift to the mobile base and undo its yaw
                # (reference BaseEnv ego mode, base_env.py:1199-1212)
                th = self.agent.base_orientation()
                xyz[:, :2] -= self.agent.base_link_pos()[:2]
                rot = np.array([[np.cos(-th), -np.sin(-th)], [np.sin(-th), np.cos(-th)]])
                xyz[:, :2] = xyz[:, :2] @ rot.T
            else:
                xyz[:, :2] -= self._ego_anchor_xy()
        obs = pcd_base(
            {"xyz": xyz, "rgb": rgb, "seg": seg},
            n_points=self.n_points, min_pts=50, fg_pts=self.n_points * 2 // 3,
            np_random=self.np_random,
        )
        return {
            "xyz": np.ascontiguousarray(obs["xyz"].T.astype(np.float32)),
            "rgb": np.ascontiguousarray(obs["rgb"].T),
            "seg": np.ascontiguousarray(obs["seg"].T.astype(np.float32)),
            "state": self._state(),
        }

    def _ego_anchor_xy(self) -> np.ndarray:
        raise NotImplementedError

    def render(self, mode="rgb_array", **kwargs):
        rgb, _, _ = self._render_camera(self.camera_names[0])
        return rgb

    def close(self):
        if self._renderers is not None:
            self._renderers.close()
            self._renderers = None
