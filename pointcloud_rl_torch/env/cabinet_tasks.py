# Copy of pointcloud_rl_tpu/env/cabinet_tasks.py for the PyTorch port (that package's env imports JAX).
"""OpenCabinetDoor / OpenCabinetDrawer on MuJoCo with procedural cabinets.

The reference tasks (``mani_skill/mani_skill/env/open_cabinet_door_drawer.py``)
drive a mobile A2 single-arm robot to pull a target door (revolute) or drawer
(prismatic) open past ``open_extent`` of its joint range and hold it still.
The PartNet-Mobility cabinet models do NOT ship in this image's asset
snapshot (only buckets do — verified in round 2), so the object set here is a
PROCEDURAL cabinet catalog: deterministic parameter sets (dims, panel
layout, handle geometry, hinge side) generated from fixed seeds, 25 train +
4 val per task, mirroring the reference's model-id split semantics
(``process_variants`` over ``cabinet_models_*.yml``).  Task logic, reward
staging, eval flags, observation contract, and segmentation masks are ports
of the reference file:

- handle discovery by name + sampled handle points + grasp-pose pair from
  the handle bbox flat direction (open_cabinet_door_drawer.py:96-184);
- target-link choice among matching-joint-type links with handles, per-level
  rng or ``fixed_target_link_id`` (open_cabinet_door_drawer.py:196-215);
- joint friction/damping sampled per level
  (open_cabinet_door_drawer.py:259-266);
- "new" staged reward: approach with the grasp-pose orientation gate, close
  the gripper on the handle (signed-distance grasp test), pull along the
  handle-frame opening direction, hold still once open
  (open_cabinet_door_drawer.py:432-560);
- eval flags ``{cabinet_static, open_enough}`` -> success with the BaseEnv
  hysteresis (open_cabinet_door_drawer.py:505-513, base_env.py:795-807);
- segmentation channels [target handle, target link, robot]
  (open_cabinet_door_drawer.py:578-592 ``_post_process_view``).

Scene convention: the cabinet stands at the origin with its FRONT facing
+x (the reference faces -x; mirrored so the grasp forward axis is -x
here).  The robot spawns on the +x side facing the cabinet.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..mani.geometry import (Pose, angle_distance, mat2quat,
                             normalize_and_clip_in_interval,
                             rotate_2d_vec_by_angle)
from .mjc_task import MujocoTaskEnv
from .spaces import Box

_SCENE = """
<mujoco model="open_cabinet">
  <compiler angle="radian"/>
  <option timestep="0.004" integrator="implicitfast"/>
  <visual>
    <quality offsamples="0" shadowsize="0"/>
  </visual>
  <asset>
    <texture type="2d" name="grid" builtin="checker" rgb1=".2 .3 .4" rgb2=".1 .15 .2" width="64" height="64"/>
    <material name="grid" texture="grid" texrepeat="4 4" reflectance="0"/>
  </asset>
  <worldbody>
    <light pos="2 1 3" dir="-0.5 -0.3 -1" diffuse="0.9 0.9 0.9" castshadow="false"/>
    <light pos="2 -1 3" dir="-0.5 0.3 -1" diffuse="0.5 0.5 0.5" castshadow="false"/>
    <geom name="ground" type="plane" size="6 6 0.1" material="grid" friction="0.5 0.005 0.0001"/>
    <camera name="cam0" pos="2.2 0.0 1.6" xyaxes="0 1 0  -0.55 0 0.83"/>
    <camera name="cam1" pos="1.4 1.8 1.5" xyaxes="-0.79 0.61 0  -0.4 -0.5 0.77"/>
    <camera name="cam2" pos="1.4 -1.8 1.5" xyaxes="0.79 0.61 0  -0.4 0.5 0.77"/>
  </worldbody>
  <actuator/>
</mujoco>
"""

PANEL = 0.018  # cabinet panel half-thickness


def cabinet_catalog(kind: str, split: str) -> List[dict]:
    """Deterministic procedural cabinet library.

    ``kind``: "door" or "drawer"; ``split``: "train" (25 models) or "val"
    (4 models, disjoint seeds) — the reference's split-file semantics
    without the PartNet assets."""
    n, seed0 = (25, 1000) if split == "train" else (4, 9000)
    out = []
    for i in range(n):
        rs = np.random.RandomState(seed0 + i + (0 if kind == "door" else 500))
        W = float(rs.uniform(0.7, 1.1))     # width  (y)
        D = float(rs.uniform(0.35, 0.5))    # depth  (x)
        H = float(rs.uniform(0.8, 1.2))     # height (z)
        spec = dict(kind=kind, W=W, D=D, H=H)
        if kind == "door":
            spec["n_units"] = int(rs.randint(1, 3))  # 1 or 2 doors
            spec["hinge_sides"] = [int(rs.randint(2)) for _ in range(spec["n_units"])]
            spec["open_range"] = float(rs.uniform(1.6, 2.2))
            spec["handle_vertical"] = True
        else:
            spec["n_units"] = int(rs.randint(2, 4))  # 2 or 3 drawers
            spec["open_range"] = float(D * rs.uniform(0.7, 0.85))
            spec["handle_vertical"] = False
        spec["handle_out"] = float(rs.uniform(0.06, 0.09))   # standoff length
        spec["handle_len"] = float(rs.uniform(0.12, 0.2))    # bar length
        spec["handle_rad"] = float(rs.uniform(0.009, 0.013))
        out.append(spec)
    return out


def _add_handle(body: ET.Element, name: str, face_x: float, cy: float, cz: float,
                out_len: float, bar_len: float, rad: float, vertical: bool) -> None:
    """U-shaped bar handle on a front panel: two standoffs + a bar, all geoms
    named ``*handle*`` (the reference discovers handles by visual-body NAME,
    open_cabinet_door_drawer.py:110-117)."""
    axis = "0 0 1" if vertical else "0 1 0"
    half = bar_len / 2
    for k, s in enumerate((-1, 1)):
        dy, dz = (0, s * half) if vertical else (s * half, 0)
        ET.SubElement(body, "geom", dict(
            name=f"{name}_handle_leg{k}", type="capsule",
            fromto=f"{face_x} {cy + dy} {cz + dz} {face_x + out_len} {cy + dy} {cz + dz}",
            size=f"{rad}", density="800", rgba="0.85 0.8 0.2 1",
            friction="1.2 0.01 0.0001"))
    dy0, dz0 = (0, -half) if vertical else (-half, 0)
    dy1, dz1 = (0, half) if vertical else (half, 0)
    ET.SubElement(body, "geom", dict(
        name=f"{name}_handle_bar", type="capsule",
        fromto=(f"{face_x + out_len} {cy + dy0} {cz + dz0} "
                f"{face_x + out_len} {cy + dy1} {cz + dz1}"),
        size=f"{rad}", density="800", rgba="0.9 0.85 0.25 1",
        friction="1.2 0.01 0.0001"))


def build_cabinet_xml(spec: dict, robot: str, joint_friction: Tuple[float, float],
                      joint_damping: Tuple[float, float], rs) -> str:
    """Compose the scene: procedural cabinet + the A2 robot.  Joint
    friction/damping are sampled per level
    (open_cabinet_door_drawer.py:259-266 ``_set_joint_physical_parameters``)."""
    from .a2_robot import a2_mjcf_parts, load_robot_yaml

    root = ET.fromstring(_SCENE)
    world = root.find("worldbody")
    asset = root.find("asset")
    W, D, H = spec["W"], spec["D"], spec["H"]
    hw, hd = W / 2, D / 2

    cab = ET.SubElement(world, "body", dict(name="cabinet", pos=f"0 0 {H / 2}"))
    frame = dict(type="box", density="600", rgba="0.45 0.3 0.2 1",
                 friction="0.5 0.005 0.0001")
    ET.SubElement(cab, "geom", dict(name="cab_left", pos=f"0 {-hw + PANEL} 0",
                                    size=f"{hd} {PANEL} {H / 2}", **frame))
    ET.SubElement(cab, "geom", dict(name="cab_right", pos=f"0 {hw - PANEL} 0",
                                    size=f"{hd} {PANEL} {H / 2}", **frame))
    ET.SubElement(cab, "geom", dict(name="cab_top", pos=f"0 0 {H / 2 - PANEL}",
                                    size=f"{hd} {hw} {PANEL}", **frame))
    ET.SubElement(cab, "geom", dict(name="cab_bottom", pos=f"0 0 {-H / 2 + PANEL}",
                                    size=f"{hd} {hw} {PANEL}", **frame))
    ET.SubElement(cab, "geom", dict(name="cab_back", pos=f"{-hd + PANEL} 0 0",
                                    size=f"{PANEL} {hw} {H / 2}", **frame))

    fric = float(rs.uniform(*joint_friction))
    damp = float(rs.uniform(*joint_damping))
    units = []
    if spec["kind"] == "door":
        n = spec["n_units"]
        dw = (W - 4 * PANEL) / n  # each door's width
        for i in range(n):
            cy = -W / 2 + 2 * PANEL + dw * (i + 0.5)
            side = spec["hinge_sides"][i]  # 0: hinge at -y edge, 1: +y edge
            hinge_y = cy - dw / 2 if side == 0 else cy + dw / 2
            body = ET.SubElement(cab, "body", dict(
                name=f"door{i}", pos=f"{hd} {hinge_y} 0"))
            # hinge axis signed so POSITIVE qpos swings the door outward
            # (+x): panel extending +y from the hinge needs -z, and vice
            # versa
            axis = "0 0 -1" if side == 0 else "0 0 1"
            ET.SubElement(body, "joint", dict(
                name=f"door{i}_joint", type="hinge", axis=axis,
                pos="0 0 0", range=f"0 {spec['open_range']}",
                damping=f"{damp}", frictionloss=f"{fric}"))
            off = dw / 2 if side == 0 else -dw / 2
            ET.SubElement(body, "geom", dict(
                name=f"door{i}_panel", type="box", pos=f"0 {off} 0",
                size=f"{PANEL} {dw / 2 - 0.002} {H / 2 - 2 * PANEL}",
                density="400", rgba="0.55 0.38 0.25 1",
                friction="0.5 0.005 0.0001"))
            # handle near the free edge, mid height
            handle_y = off + (0.32 * dw if side == 0 else -0.32 * dw)
            _add_handle(body, f"door{i}", PANEL, handle_y, 0.0,
                        spec["handle_out"], spec["handle_len"],
                        spec["handle_rad"], vertical=True)
            units.append((f"door{i}", "hinge"))
    else:
        n = spec["n_units"]
        dh = (H - 4 * PANEL) / n  # each drawer's height
        for i in range(n):
            cz = -H / 2 + 2 * PANEL + dh * (i + 0.5)
            body = ET.SubElement(cab, "body", dict(
                name=f"drawer{i}", pos=f"{hd} 0 {cz}"))
            ET.SubElement(body, "joint", dict(
                name=f"drawer{i}_joint", type="slide", axis="1 0 0",
                range=f"0 {spec['open_range']}",
                damping=f"{damp}", frictionloss=f"{fric}"))
            box = dict(type="box", density="300", rgba="0.6 0.42 0.28 1",
                       friction="0.5 0.005 0.0001")
            iw = hw - 3 * PANEL  # interior half width
            ET.SubElement(body, "geom", dict(
                name=f"drawer{i}_front", pos="0 0 0",
                size=f"{PANEL} {iw} {dh / 2 - 0.004}", **box))
            ET.SubElement(body, "geom", dict(
                name=f"drawer{i}_bottom", pos=f"{-hd + PANEL} 0 {-dh / 2 + PANEL + 0.004}",
                size=f"{hd - 2 * PANEL} {iw} {PANEL}", **box))
            for k, s in enumerate((-1, 1)):
                ET.SubElement(body, "geom", dict(
                    name=f"drawer{i}_side{k}", pos=f"{-hd + PANEL} {s * (iw - PANEL)} 0",
                    size=f"{hd - 2 * PANEL} {PANEL} {dh / 2 - 0.004}", **box))
            _add_handle(body, f"drawer{i}", PANEL, 0.0, 0.0,
                        spec["handle_out"], spec["handle_len"],
                        spec["handle_rad"], vertical=False)
            units.append((f"drawer{i}", "slide"))

    rb_meshes, rb_body, rb_acts = a2_mjcf_parts(robot, load_robot_yaml(robot))
    for mesh in rb_meshes:
        asset.append(mesh)
    world.append(rb_body)
    actuator = root.find("actuator")
    for a in rb_acts:
        actuator.append(a)
    contact = ET.SubElement(root, "contact")
    ET.SubElement(contact, "exclude", dict(body1="adjustable_body", body2="world"))
    return ET.tostring(root, encoding="unicode")


def _box_signed_distance(p: np.ndarray, half: np.ndarray) -> np.ndarray:
    """Signed distance of points to an origin-centered AABB, POSITIVE inside
    (the trimesh ``signed_distance`` convention the reference relies on,
    open_cabinet_door_drawer.py:399-406)."""
    q = np.abs(p) - half
    outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
    inside = np.minimum(q.max(-1), 0.0)
    return -(outside + inside)


class OpenCabinetEnvBase(MujocoTaskEnv):
    """Shared door/drawer logic; see module docstring.  Registered names:
    ``OpenCabinetDoorMJC_{train,val}-v0`` /
    ``OpenCabinetDrawerMJC_{train,val}-v0``."""

    joint_kind = "hinge"  # subclass: "hinge" (door) / "slide" (drawer)

    def __init__(
        self,
        split: str = "train",
        obs_mode: str = "pointcloud",
        n_points: int = 1200,
        image_hw: Tuple[int, int] = (64, 112),
        horizon: int = 200,
        open_extent: float = 0.9,
        joint_friction: Tuple[float, float] = (0.05, 0.15),
        joint_damping: Tuple[float, float] = (5.0, 20.0),
        fixed_target_link_id: Optional[int] = None,
        keep_good_steps_threshold: int = 3,
        reward_type: str = "dense",
        max_depth: float = 6.0,
        ego_mode: bool = False,
        robot: str = "a2_single",
        **kwargs,
    ):
        from .a2_robot import A2Robot, robot_assets_available

        assert robot_assets_available(), "A2 robot assets/configs not found"
        self.catalog = cabinet_catalog(
            "door" if self.joint_kind == "hinge" else "drawer", split)
        self.obs_mode = obs_mode
        self.n_points = n_points
        self.image_hw = tuple(image_hw)
        self.horizon = horizon
        self.open_extent = float(open_extent)
        self.joint_friction = joint_friction
        self.joint_damping = joint_damping
        self.fixed_target_link_id = fixed_target_link_id
        self.keep_good_steps_threshold = keep_good_steps_threshold
        self.reward_type = reward_type
        self.max_depth = max_depth
        self.ego_mode = ego_mode
        self.robot = robot
        # A2 timing identical to MoveBucketMJC: 250 Hz sim, 50 Hz control,
        # 2 control steps per env step -> 25 Hz
        self.n_sim_per_control = 5
        self.ctrl_per_step = 2
        self.agent = A2Robot(robot, control_freq=1.0 / (0.004 * self.n_sim_per_control))
        self.action_space = Box(-1.0, 1.0, (len(self.agent.controllable_joints),))
        self.np_random = np.random.RandomState()
        self._renderers = None
        self.model = None
        self._step_count = 0
        self._reset_hysteresis()

    # ------------------------------------------------------------- reset
    def reset(self, level: Optional[int] = None, **kwargs):
        import mujoco

        if level is not None:
            self.np_random.seed(int(level))
        rs = self.np_random
        self._step_count = 0
        self._reset_hysteresis()

        idx = int(rs.randint(len(self.catalog)))
        self.spec = self.catalog[idx]
        self.model_id = f"{self.spec['kind']}{idx}"
        xml = build_cabinet_xml(self.spec, self.robot, self.joint_friction,
                                self.joint_damping, rs)
        self.model = mujoco.MjModel.from_xml_string(xml)
        self.data = mujoco.MjData(self.model)
        self._renderers = None
        self.agent.bind(self.model, self.data)
        self.agent.reset()

        self._find_units()
        self._choose_target_link(rs)
        self._close_all_parts()
        self._place_robot(rs)
        mujoco.mj_forward(self.model, self.data)
        self._prepare_handle_info(rs)

        lo, hi = self._target_range()
        self.target_qpos = lo + (hi - lo) * self.open_extent
        # reference init_arm_qpos: the arm-joint block of the agent state
        # (open_cabinet_door_drawer.py:87 qpos[1:-3]; ours is qpos[1:-2] —
        # [height, arm x7, fingers x2] layout)
        self.init_arm_qpos = self.agent.get_state()["qpos"][1:-2].copy()
        for _ in range(25):  # settle
            self.agent.simulation_step()
            mujoco.mj_step(self.model, self.data)
        return self.get_obs()

    def _find_units(self) -> None:
        """Door/drawer bodies + their handle geoms, by name (the reference's
        name-based handle discovery, open_cabinet_door_drawer.py:96-125)."""
        import mujoco

        m = self.model
        self.units = []  # (body_id, joint_id, [handle geom ids])
        for j in range(m.njnt):
            jname = mujoco.mj_id2name(m, mujoco.mjtObj.mjOBJ_JOINT, j) or ""
            if not (jname.startswith("door") or jname.startswith("drawer")):
                continue
            bid = int(m.jnt_bodyid[j])
            bname = mujoco.mj_id2name(m, mujoco.mjtObj.mjOBJ_BODY, bid) or ""
            handles = [g for g in range(m.ngeom)
                       if m.geom_bodyid[g] == bid and
                       "handle" in (mujoco.mj_id2name(m, mujoco.mjtObj.mjOBJ_GEOM, g) or "")]
            if handles:
                self.units.append((bid, j, handles, bname))
        assert self.units, "cabinet has no handle-bearing articulated links"

    @property
    def num_target_links(self) -> int:
        """open_cabinet_door_drawer.py:594-599."""
        return len(self.units)

    def _choose_target_link(self, rs) -> None:
        """open_cabinet_door_drawer.py:196-215."""
        if self.fixed_target_link_id is not None:
            self.target_index = self.fixed_target_link_id % len(self.units)
        else:
            self.target_index = int(rs.choice(len(self.units)))
        bid, jid, handles, bname = self.units[self.target_index]
        self.target_body = bid
        self.target_joint = jid
        self.target_handle_geoms = handles
        self.target_link_name = bname
        self.target_indicator = np.zeros(8, np.float32)  # cabinet_max_dof=8
        self.target_indicator[self.target_index] = 1
        # segmentation: [target handle, target link, robot]
        robot_root = self._robot_root_body()
        self._seg_geoms = [set(handles),
                           self._geoms_of(self._subtree(bid)),
                           self._geoms_of(self._subtree(robot_root))]

    def _robot_root_body(self) -> int:
        import mujoco

        m = self.model
        jid = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_JOINT, "root_x_axis_joint")
        rb = int(m.jnt_bodyid[jid])
        while m.body_parentid[rb] != 0:
            rb = m.body_parentid[rb]
        return rb

    def _close_all_parts(self) -> None:
        """qpos of every unit to its lower limit
        (open_cabinet_door_drawer.py:186-194)."""
        m = self.model
        for _, jid, _, _ in self.units:
            self.data.qpos[m.jnt_qposadr[jid]] = m.jnt_range[jid][0]
        self.data.qvel[:] = 0

    def _target_range(self) -> Tuple[float, float]:
        lo, hi = self.model.jnt_range[self.target_joint]
        return float(lo), float(hi)

    def _place_robot(self, rs) -> None:
        """Mirror of open_cabinet_door_drawer.py:217-239 on the +x side:
        base 1.3-1.5 m from the cabinet front, ±0.1π around head-on,
        facing the cabinet with a small orientation perturbation."""
        dist = rs.uniform(1.3, 1.5)
        theta = rs.uniform(-0.1 * np.pi, 0.1 * np.pi)
        front_x = self.spec["D"] / 2
        base_pos = np.array([front_x + np.cos(theta) * dist, np.sin(theta) * dist])
        base_theta = np.pi + theta + rs.uniform(-0.05 * np.pi, 0.05 * np.pi)
        self.agent.set_state({"base_pos": base_pos, "base_orientation": base_theta})

    # ----------------------------------------------------- handle geometry
    def _prepare_handle_info(self, rs) -> None:
        """Handle sample points + bbox + grasp-pose pair, all in the target
        LINK frame (open_cabinet_door_drawer.py:123-184)."""
        m, d = self.model, self.data
        pts = []
        for g in self.target_handle_geoms:
            # capsule: sample along the segment + radial jitter
            size = m.geom_size[g]
            n = 34
            t = rs.uniform(0, 1, n)[:, None]
            if m.geom_type[g] == 3:  # mjGEOM_CAPSULE: z-aligned, half-len size[1]
                local = np.concatenate([
                    rs.normal(scale=size[0] * 0.5, size=(n, 2)),
                    (t * 2 - 1) * size[1]], axis=1)
            else:  # box
                local = (rs.uniform(-1, 1, (n, 3))) * size[None, :3]
            R = d.geom_xmat[g].reshape(3, 3)
            pts.append(local @ R.T + d.geom_xpos[g])
        pts_world = np.concatenate(pts)
        # into the link frame (stable as the link moves)
        Rl = d.xmat[self.target_body].reshape(3, 3)
        ol = d.xpos[self.target_body]
        self.handle_pts_local = (pts_world - ol) @ Rl

        mins, maxs = self.handle_pts_local.min(0), self.handle_pts_local.max(0)
        self.handle_center_local = (mins + maxs) / 2
        self.handle_half_local = np.maximum((maxs - mins) / 2, 1e-4)
        lens = maxs - mins

        # grasp poses (open_cabinet_door_drawer.py:138-179): flat along the
        # handle bar; forward INTO the cabinet front (-x here, +x reference)
        flat = np.array([0.0, 0.0, 1.0]) if lens[1] > lens[2] else np.array([0.0, 1.0, 0.0])
        forward = np.array([-1.0, 0.0, 0.0])

        def build_pose(fwd, flt):
            extra = np.cross(flt, fwd)
            R = np.stack([extra, flt, fwd], axis=1)
            return Pose(np.zeros(3), mat2quat(R))

        link_pose = Pose(ol.copy(), mat2quat(Rl))
        self.grasp_pose_local = (link_pose.inv() * build_pose(forward, flat),
                                 link_pose.inv() * build_pose(forward, -flat))

    def _target_link_pose(self) -> Pose:
        d = self.data
        return Pose(d.xpos[self.target_body].copy(),
                    mat2quat(d.xmat[self.target_body].reshape(3, 3)))

    def _handle_points_world(self) -> np.ndarray:
        d = self.data
        R = d.xmat[self.target_body].reshape(3, 3)
        return self.handle_pts_local @ R.T + d.xpos[self.target_body]

    def _handle_signed_distance(self, p_world: np.ndarray) -> np.ndarray:
        """Signed distance (positive inside) to the handle assembly's
        link-frame bbox — the analytic stand-in for the reference's
        convex-hull trimesh queries (open_cabinet_door_drawer.py:396-406)."""
        d = self.data
        R = d.xmat[self.target_body].reshape(3, 3)
        local = (p_world - d.xpos[self.target_body]) @ R - self.handle_center_local
        return _box_signed_distance(local, self.handle_half_local)

    # ------------------------------------------------------------- stepping
    def step(self, action):
        action = np.clip(np.asarray(action, np.float32), -1, 1)
        self._step_agent(action)
        self._step_count += 1

        # The reference reward reads the RAW flag dict (compute_eval_flag_dict
        # at open_cabinet_door_drawer.py:315), while hysteresis debouncing
        # applies only to the eval/success accounting (base_env.py:795-807).
        raw_flags = self._raw_eval_flags()
        eval_info, success = self._eval(raw_flags)
        reward, rew_info = self._dense_reward(action, raw_flags)
        if self.reward_type == "sparse":
            reward = float(success)
        done = bool(success or self._step_count >= self.horizon)
        info = {"success": success, "eval_info": eval_info, **rew_info}
        if done and not success:
            info["TimeLimit.truncated"] = True
        return self.get_obs(), float(reward), done, info

    # ------------------------------------------------------------ eval/rew
    def _target_qpos_now(self) -> Tuple[float, float]:
        m = self.model
        adr, dadr = m.jnt_qposadr[self.target_joint], m.jnt_dofadr[self.target_joint]
        return float(self.data.qpos[adr]), float(self.data.qvel[dadr])

    def _link_static(self, max_v=0.1, max_ang_v=1.0) -> bool:
        """check_actor_static on the target link (base_env.py helper used at
        open_cabinet_door_drawer.py:506)."""
        import mujoco

        v6 = np.zeros(6)
        mujoco.mj_objectVelocity(self.model, self.data, mujoco.mjtObj.mjOBJ_BODY,
                                 self.target_body, v6, 0)
        return bool(np.linalg.norm(v6[3:]) <= max_v and np.linalg.norm(v6[:3]) <= max_ang_v)

    def _raw_eval_flags(self):
        qpos, _ = self._target_qpos_now()
        return {
            "cabinet_static": self._link_static(),
            "open_enough": bool(qpos >= self.target_qpos),
        }

    def _eval(self, raw_flags=None):
        flags = dict(self._raw_eval_flags() if raw_flags is None else raw_flags)
        result = self._apply_hysteresis(flags)
        return result, result["success"]

    def _dense_reward(self, action, eval_flags):
        """Port of the reference "new" staged reward
        (open_cabinet_door_drawer.py:432-560), single-arm."""
        agent = self.agent
        ee_sample = agent.get_ee_coords_sample()          # [2, 10, 3]
        handle_pts = self._handle_points_world()          # [K, 3]

        ee_mean = ee_sample.mean(0)                       # [10, 3]
        dist_ee_to_handle = float(np.linalg.norm(
            ee_mean[:, None] - handle_pts[None], axis=-1).min(-1).mean())

        sd_mid = float(self._handle_signed_distance(ee_mean).max())
        sd_per_finger = self._handle_signed_distance(
            ee_sample.reshape(-1, 3)).reshape(2, -1).max(1)
        close_to_grasp = bool(sd_per_finger.min() > -1e-2)
        ee_in_grasp_pose = bool(sd_mid > -1e-2)
        grasp_happen = ee_in_grasp_pose and close_to_grasp
        ee_close_to_handle = dist_ee_to_handle <= 0.03

        cabinet_qpos, cabinet_qvel = self._target_qpos_now()

        state = agent.get_state()
        robot_qpos = state["qpos"]
        gripper_qpos = robot_qpos[-2:]

        hand_pose = agent.hand_pose()
        hand_vel = agent.hand_vel()
        link_pose = self._target_link_pose()
        target_pose = link_pose * self.grasp_pose_local[0]
        target_pose_2 = link_pose * self.grasp_pose_local[1]
        # opening direction: the grasp frame's -z (reference :458)
        target_vel = (target_pose.to_transformation_matrix()[:3, :3] @ np.array([0, 0, -1.0]))[:2]

        if self.ego_mode:
            target_action = rotate_2d_vec_by_angle(target_vel, -agent.base_orientation())
        else:
            target_action = target_vel
        base_action_err = -float(np.linalg.norm(action[:2] - target_action))
        gripper_vel_rew = -float(np.linalg.norm(hand_vel[:2] - target_vel))

        angle1 = abs(angle_distance(hand_pose.q, target_pose.q))
        angle2 = abs(angle_distance(hand_pose.q, target_pose_2.q))
        gripper_angle_err = min(angle1, angle2)  # already /pi-normalized

        open_gripper_rew = 10 * float(gripper_qpos.mean())
        close_gripper_rew = -10 * float(gripper_qpos.mean()) + 0.45

        open_cabinet_reward = 0.0
        static_reward = 0.0
        gripper_vel_stage_rew = 0.0
        keep_static_reward = 0.0

        arm_qpos = robot_qpos[1:-2]
        arm_pos_err = float(np.abs(self.init_arm_qpos - arm_qpos).mean())
        keep_arm_rew = -arm_pos_err - float(np.abs(action[4:-2]).mean())
        close_to_cabinet_rew = (
            -float(np.clip(gripper_angle_err, 1 / 12.0, 1)) * 1.5
            - dist_ee_to_handle * 2 + sd_mid)
        good_pose_rew = -float(np.clip(gripper_angle_err, 1 / 12.0, 1)) * 0.4 + 0.4

        gripper_rew = open_gripper_rew
        stage_index = 0

        if gripper_angle_err * 180 <= 25 and ee_close_to_handle:
            stage_index = 2
            gripper_rew = close_gripper_rew + good_pose_rew
            if grasp_happen:
                stage_index = 3
                gripper_vel_stage_rew = float(np.clip(
                    base_action_err + gripper_vel_rew, -2, 0)) + 2
                close_to_cabinet_rew = 0.1
                keep_arm_rew = 0.0
                open_cabinet_reward = (
                    normalize_and_clip_in_interval(cabinet_qpos, 0, self.target_qpos * 1.1)
                    + float(np.clip(cabinet_qvel, -0.5, 0.5)) + 0.5)
                if eval_flags["open_enough"]:
                    stage_index = 4
                    gripper_vel_stage_rew = 2.5
                    open_cabinet_reward = 2.0
                    static_reward = (-float(np.clip(np.abs(action), 0, 1).mean()) + 1) * 2
                    if eval_flags["cabinet_static"]:
                        stage_index = 5
                        keep_static_reward += 1.0

        reward = (close_to_cabinet_rew + keep_arm_rew + gripper_rew
                  + gripper_vel_stage_rew + open_cabinet_reward
                  + static_reward + keep_static_reward)

        info = {
            "dist_ee_to_handle": dist_ee_to_handle,
            "sd_ee_mid_to_handle": sd_mid,
            "gripper_angle_err": gripper_angle_err * 180,
            "to_cabinet_rew": close_to_cabinet_rew,
            "gripper_rew": gripper_rew,
            "keep_arm_rew": keep_arm_rew,
            "gripper_vel_rew": gripper_vel_stage_rew,
            "open_cabinet_reward": open_cabinet_reward,
            "static_reward": static_reward,
            "keep_static_reward": keep_static_reward,
            "qpos": cabinet_qpos,
            "qvel": cabinet_qvel,
            "target_qpos": self.target_qpos,
            "open_extent_frac": cabinet_qpos / max(self.target_qpos, 1e-6),
            "ee_close_to_handle": float(ee_close_to_handle),
            "grasp_happen": float(grasp_happen),
            "open_enough": float(eval_flags["open_enough"]),
            "cabinet_static": float(eval_flags["cabinet_static"]),
            "stage_index": stage_index,
        }
        return float(reward), info

    # ---------------------------------------------------------------- obs
    def _state(self) -> np.ndarray:
        return self.agent.get_obs(self.ego_mode)

    def _state_extras(self):
        """obs_mode='state' extras: target indicator + live handle center +
        normalized joint progress (get_additional_task_info +
        get_visual_state quantities, open_cabinet_door_drawer.py:50-67,255)."""
        qpos, _ = self._target_qpos_now()
        handle_center = self._handle_points_world().mean(0)
        return [self.target_indicator, handle_center,
                np.array([qpos / max(self.target_qpos, 1e-6)])]

    def _ego_anchor_xy(self) -> np.ndarray:
        return self.agent.base_link_pos()[:2]

    def get_env_state(self):
        return {"qpos": self.data.qpos.copy(), "qvel": self.data.qvel.copy(),
                "model_id": self.model_id,
                "target_index": int(self.target_index)}


class OpenCabinetDoorEnv(OpenCabinetEnvBase):
    """open_cabinet_door_drawer.py:718-727 (revolute targets)."""
    joint_kind = "hinge"


class OpenCabinetDrawerEnv(OpenCabinetEnvBase):
    """open_cabinet_door_drawer.py:730-738 (prismatic targets)."""
    joint_kind = "slide"
