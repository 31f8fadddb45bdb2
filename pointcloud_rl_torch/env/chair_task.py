# Copy of pointcloud_rl_tpu/env/chair_task.py for the PyTorch port (that package's env imports JAX).
"""PushChair on MuJoCo with procedural swivel chairs.

The reference task (``mani_skill/mani_skill/env/push_chair.py``) drives the
mobile A2 DUAL-arm robot to push an office chair to a ground target and keep
it upright and still.  The PartNet-Mobility chair models do NOT ship in this
image's asset snapshot (only buckets do — verified in round 2), so the object
set is a PROCEDURAL chair catalog: deterministic parameter sets (seat/back
dims, leg count, wheel size, swivel joint) from fixed seeds, 25 train + 4 val,
mirroring the reference's model-id split semantics.  Task logic is a port of
the reference file:

- placement: chair 0.8-1.2 m from the target at a uniform angle, yaw facing
  the target +- 0.4*pi perturbation; robot 0.8-1.2 m behind the chair
  facing it (push_chair.py:96-142);
- per-level physics: gas-lift ("helper") swivel joint friction/damping and
  low-friction wheel contacts (push_chair.py:47-72 _set_physical_parameters,
  push_chair.yml object_material friction 0.1);
- chair surface points sampled per link at reset, transformed by the live
  link poses for the ee-to-chair distance (push_chair.py:144-166
  _load_chair_pcds + compute_dense_reward:218-228);
- dense reward: approach ee to the chair, keep it upright (tilt gate
  0.2*pi), push with velocity-direction shaping toward the target, then
  reward stillness inside the target radius; staged bonuses from -10
  (+2 per stage, -5 tilt penalty), all scaled by 2
  (push_chair.py:215-283);
- eval flags {chair_close_to_target, chair_standing, chair_static} ->
  success with the BaseEnv hysteresis (push_chair.py:285-296);
- segmentation channels [chair back, chair seat, target indicator]
  (push_chair.py:306-388 get_inst_labels target parts);
- agent: dual-arm A2 with the task's initial arm pose
  (push_chair.yml agent _override initial_qpos).

Scene convention: the target is at the ORIGIN (reference _set_target),
marked by a contact-free red disk geom.  The chair's local +x is its front;
its BACK faces the robot, which pushes the backrest toward the target.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import List, Optional, Tuple

import numpy as np

from .mjc_task import MujocoTaskEnv
from .spaces import Box

_SCENE = """
<mujoco model="push_chair">
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
    <light pos="-2 -1 3" dir="0.5 0.3 -1" diffuse="0.5 0.5 0.5" castshadow="false"/>
    <geom name="ground" type="plane" size="6 6 0.1" material="grid" friction="0.1 0.005 0.0001"/>
    <geom name="target_indicator" type="cylinder" pos="0 0 0.005" size="0.15 0.005"
          rgba="1 0 0 1" contype="0" conaffinity="0"/>
    <camera name="cam0" pos="2.6 0.0 2.0" xyaxes="0 1 0  -0.6 0 0.8"/>
    <camera name="cam1" pos="-1.3 2.3 2.0" xyaxes="-0.87 -0.49 0  0.3 -0.53 0.79"/>
    <camera name="cam2" pos="-1.3 -2.3 2.0" xyaxes="0.87 -0.49 0  0.3 0.53 0.79"/>
  </worldbody>
  <actuator/>
</mujoco>
"""


def chair_catalog(split: str) -> List[dict]:
    """Deterministic procedural chair library: 25 train + 4 val specs
    (the reference's ``chair_models.yml`` split semantics without the
    PartNet assets)."""
    n, seed0 = (25, 3000) if split == "train" else (4, 9500)
    out = []
    for i in range(n):
        rs = np.random.RandomState(seed0 + i)
        out.append(dict(
            seat_w=float(rs.uniform(0.38, 0.50)),     # y extent
            seat_d=float(rs.uniform(0.38, 0.48)),     # x extent
            seat_h=float(rs.uniform(0.42, 0.58)),     # seat top height
            back_h=float(rs.uniform(0.35, 0.60)),
            back_tilt=float(rs.uniform(0.0, 0.15)),   # rad, leaning backward
            n_legs=int(rs.randint(4, 6)),             # 4 or 5 casters
            leg_span=float(rs.uniform(0.25, 0.33)),
            wheel_r=float(rs.uniform(0.030, 0.045)),
            swivel=bool(rs.randint(2)),               # gas-lift rotation joint
            density=float(rs.uniform(150.0, 260.0)),
        ))
    return out


def build_chair_xml(spec: dict, chair_xy, chair_yaw: float,
                    helper_fd: Tuple[float, float], robot: str) -> str:
    """Compose the scene: target disk + procedural chair + the A2 robot.
    ``helper_fd`` = (frictionloss, damping) for the swivel joint, sampled
    per level (push_chair.py:47-60)."""
    from .a2_robot import a2_mjcf_parts, load_robot_yaml

    root = ET.fromstring(_SCENE)
    world = root.find("worldbody")
    asset = root.find("asset")

    dens = spec["density"]
    wheel_r = spec["wheel_r"]
    seat_h = spec["seat_h"]
    col_top = seat_h - 0.05

    chair = ET.SubElement(world, "body", dict(
        name="chair_root", pos=f"{chair_xy[0]} {chair_xy[1]} 0",
        axisangle=f"0 0 1 {chair_yaw}"))
    ET.SubElement(chair, "freejoint", dict(name="chair_root"))
    # central gas-lift column ("support"/"leg" in the reference naming)
    ET.SubElement(chair, "geom", dict(
        name="leg_column", type="capsule",
        fromto=f"0 0 {wheel_r + 0.02} 0 0 {col_top}", size="0.03",
        density=f"{dens}", rgba="0.3 0.3 0.35 1", friction="0.1 0.005 0.0001"))
    # star base: n_legs capsules with caster-wheel spheres at the tips
    for k in range(spec["n_legs"]):
        ang = 2 * np.pi * k / spec["n_legs"]
        tx = np.cos(ang) * spec["leg_span"]
        ty = np.sin(ang) * spec["leg_span"]
        ET.SubElement(chair, "geom", dict(
            name=f"foot_leg{k}", type="capsule",
            fromto=f"0 0 {wheel_r + 0.02} {tx} {ty} {wheel_r + 0.01}",
            size="0.018", density=f"{dens}", rgba="0.3 0.3 0.35 1",
            friction="0.1 0.005 0.0001"))
        ET.SubElement(chair, "geom", dict(
            name=f"wheel{k}", type="sphere", pos=f"{tx} {ty} {wheel_r}",
            size=f"{wheel_r}", density=f"{dens}", rgba="0.15 0.15 0.15 1",
            friction="0.1 0.005 0.0001"))

    # seat assembly: optionally on a revolute "helper" joint (gas-lift swivel)
    if spec["swivel"]:
        seat_asm = ET.SubElement(chair, "body", dict(name="helper_seat", pos="0 0 0"))
        ET.SubElement(seat_asm, "joint", dict(
            name="helper_joint", type="hinge", axis="0 0 1",
            frictionloss=f"{helper_fd[0]}", damping=f"{helper_fd[1]}"))
    else:
        seat_asm = chair
    sw, sd = spec["seat_w"] / 2, spec["seat_d"] / 2
    ET.SubElement(seat_asm, "geom", dict(
        name="seat_surface", type="box", pos=f"0 0 {seat_h}",
        size=f"{sd} {sw} 0.03", density=f"{dens}",
        rgba="0.2 0.35 0.6 1", friction="0.3 0.005 0.0001"))
    # backrest: on the -x (rear) edge, leaning backward by back_tilt; the
    # robot spawns behind it and pushes it toward the target (+ chair front)
    bh = spec["back_h"] / 2
    tilt = spec["back_tilt"]
    bx = -sd + 0.02 - np.sin(tilt) * bh
    bz = seat_h + 0.03 + np.cos(tilt) * bh
    back = ET.SubElement(seat_asm, "body", dict(
        name="back_body", pos=f"{bx} 0 {bz}", axisangle=f"0 1 0 {-tilt}"))
    ET.SubElement(back, "geom", dict(
        name="back_surface", type="box", pos="0 0 0",
        size=f"0.025 {sw} {bh}", density=f"{dens}",
        rgba="0.2 0.35 0.6 1", friction="0.3 0.005 0.0001"))

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


class PushChairEnv(MujocoTaskEnv):
    """PushChair (reference push_chair.py semantics) on MuJoCo.  Registered
    env names: ``PushChairMJC_train-v0`` / ``PushChairMJC_val-v0``."""

    def __init__(
        self,
        split: str = "train",
        obs_mode: str = "pointcloud",
        n_points: int = 1200,
        image_hw: Tuple[int, int] = (64, 112),
        horizon: int = 200,
        target_radius: float = 0.15,
        keep_good_steps_threshold: int = 3,
        reward_type: str = "dense",
        max_depth: float = 6.0,
        ego_mode: bool = False,
        robot: str = "a2_dual",
        robot_init_range: Tuple[float, float] = (0.8, 1.2),
        **kwargs,
    ):
        from .a2_robot import A2Robot, robot_assets_available

        assert robot_assets_available(), "A2 robot assets/configs not found"
        self.catalog = chair_catalog(split)
        self.obs_mode = obs_mode
        self.n_points = n_points
        self.image_hw = tuple(image_hw)
        self.horizon = horizon
        self.target_radius = float(target_radius)  # push_chair.yml custom
        self.keep_good_steps_threshold = keep_good_steps_threshold
        self.reward_type = reward_type
        self.max_depth = max_depth
        self.ego_mode = ego_mode
        self.robot = robot
        # Reach-curriculum knob: the reference spawns the robot 0.8-1.2 m
        # beyond the chair (push_chair.py:120-142, the default).  PushChair's
        # stage-1 gate (mean EE distance < 0.1 m) is the hardest reach in the
        # suite — the approach is ~2x MoveBucket's 0.6-0.8 m AND the chair
        # rolls away on low-friction casters when touched — so short training
        # budgets can shrink this range (e.g. [0.3, 0.6]) to demonstrate the
        # staged ladder opens, then anneal back to the reference range.
        self.robot_init_range = (float(robot_init_range[0]), float(robot_init_range[1]))
        self.target_xy = np.zeros(2)  # reference _set_target: the origin
        self.n_sim_per_control = 5
        self.ctrl_per_step = 2
        self.agent = A2Robot(robot, control_freq=1.0 / (0.004 * self.n_sim_per_control))
        # the task's arm pose override (push_chair.yml agent _override
        # initial_qpos): torso at 0.9, elbows folded, grippers open
        if robot == "a2_dual":
            self.agent.initial_qpos = np.array(
                [0, 0, 0, 0.9,
                 0, 0, 0, -1.5, 0, 3, 0.78, 0.02, 0.02,
                 0, 0, 0, -1.5, 0, 3, 0.78, 0.02, 0.02], np.float64)
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
        self.model_id = f"chair{idx}"

        # chair placement (push_chair.py:96-118): 0.8-1.2 m from the target
        # at a uniform angle; front (+x local) toward the target +- 0.4*pi
        dist = rs.uniform(0.8, 1.2)
        theta = rs.uniform(-np.pi, np.pi)
        chair_xy = self.target_xy + np.array([np.cos(theta), np.sin(theta)]) * dist
        perturb = rs.uniform(-0.4 * np.pi, 0.4 * np.pi)
        chair_yaw = np.pi + theta + perturb  # +x local -> roughly the target
        self.init_chair_orientation = theta + perturb

        helper_fd = (rs.uniform(0.05, 0.15), rs.uniform(5.0, 15.0))
        xml = build_chair_xml(self.spec, chair_xy, chair_yaw, helper_fd, self.robot)
        self.model = mujoco.MjModel.from_xml_string(xml)
        self.data = mujoco.MjData(self.model)
        self._renderers = None
        self._name_ids()
        self.agent.bind(self.model, self.data)
        self.agent.reset()

        # robot placement (push_chair.py:120-142): 0.8-1.2 m beyond the
        # chair (away from the target), facing back toward it
        rtheta = self.init_chair_orientation + rs.uniform(-0.2 * np.pi, 0.2 * np.pi)
        rdist = rs.uniform(*self.robot_init_range)
        base_pos = chair_xy + np.array([np.cos(rtheta), np.sin(rtheta)]) * rdist
        base_theta = -np.pi + rtheta + rs.uniform(-0.05 * np.pi, 0.05 * np.pi)
        self.agent.set_state({"base_pos": base_pos, "base_orientation": base_theta})

        mujoco.mj_forward(self.model, self.data)
        self._load_chair_points(rs)
        for _ in range(50):  # settle onto the casters
            self.agent.simulation_step()
            mujoco.mj_step(self.model, self.data)
        return self.get_obs()

    def _name_ids(self) -> None:
        import mujoco

        m = self.model
        self._chair_body = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_BODY, "chair_root")
        jid = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_JOINT, "chair_root")
        self._chair_qpos = int(m.jnt_qposadr[jid])
        self._chair_dof = int(m.jnt_dofadr[jid])
        back_geoms, seat_geoms = set(), set()
        for g in range(m.ngeom):
            gname = mujoco.mj_id2name(m, mujoco.mjtObj.mjOBJ_GEOM, g) or ""
            if "back" in gname:
                back_geoms.add(g)
            elif "seat" in gname:
                seat_geoms.add(g)
        ti = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_GEOM, "target_indicator")
        # segmentation channels [chair back, chair seat, target indicator]
        # (push_chair.py get_inst_labels: back=0, seat=1, target=2)
        self._seg_geoms = [back_geoms, seat_geoms, {ti}]

    def _load_chair_points(self, rs, per_geom: int = 48) -> None:
        """Surface-point library per chair geom in BODY-local frames
        (reference _load_chair_pcds samples 512 points per link mesh;
        analytic geom sampling here).  Stored as (body_id, local_pts)."""
        import mujoco

        m, d = self.model, self.data
        chair_geoms = [g for g in range(m.ngeom)
                       if self._in_subtree(int(m.geom_bodyid[g]), self._chair_body)]
        self._chair_pts = []
        for g in chair_geoms:
            size = m.geom_size[g]
            t = m.geom_type[g]
            if t == mujoco.mjtGeom.mjGEOM_BOX:
                local = rs.uniform(-1, 1, (per_geom, 3)) * size[None, :3]
                # project onto the box surface on a random axis
                ax = rs.randint(3, size=per_geom)
                sign = np.where(rs.randint(2, size=per_geom) > 0, 1.0, -1.0)
                local[np.arange(per_geom), ax] = sign * size[ax]
            elif t == mujoco.mjtGeom.mjGEOM_CAPSULE:
                z = rs.uniform(-size[1], size[1], per_geom)
                phi = rs.uniform(0, 2 * np.pi, per_geom)
                local = np.stack([np.cos(phi) * size[0], np.sin(phi) * size[0], z], 1)
            elif t == mujoco.mjtGeom.mjGEOM_SPHERE:
                v = rs.normal(size=(per_geom, 3))
                local = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-9) * size[0]
            else:
                continue
            # geom-local -> body-local
            bid = int(m.geom_bodyid[g])
            Rg = d.geom_xmat[g].reshape(3, 3)
            pg = d.geom_xpos[g]
            Rb = d.xmat[bid].reshape(3, 3)
            pb = d.xpos[bid]
            body_local = (local @ Rg.T + pg - pb) @ Rb
            self._chair_pts.append((bid, body_local.astype(np.float64)))

    def _chair_points_world(self) -> np.ndarray:
        d = self.data
        out = []
        for bid, local in self._chair_pts:
            R = d.xmat[bid].reshape(3, 3)
            out.append(local @ R.T + d.xpos[bid])
        return np.concatenate(out)

    # ------------------------------------------------------------- stepping
    def step(self, action):
        action = np.clip(np.asarray(action, np.float32), -1, 1)
        self._step_agent(action)
        self._step_count += 1

        eval_info, success = self._eval()
        reward, rew_info = self._dense_reward(action)
        if self.reward_type == "sparse":
            reward = float(success)
        done = bool(success or self._step_count >= self.horizon)
        info = {"success": success, "eval_info": eval_info, **rew_info}
        if done and not success:
            info["TimeLimit.truncated"] = True
        return self.get_obs(), float(reward), done, info

    # ------------------------------------------------------------ eval/rew
    def _chair_z_tilt(self) -> float:
        """Radians between world z and the chair z axis — the mani_skill
        ``angle_between_vec`` (geometry.py:43, arccos of |dot|), NOT the
        /pi-normalized pyrl variant in mani.geometry."""
        z_chair = self.data.xmat[self._chair_body].reshape(3, 3)[:, 2]
        return float(np.arccos(np.clip(abs(z_chair[2]), 0.0, 1.0)))

    def _chair_vels(self) -> Tuple[np.ndarray, np.ndarray]:
        qv = self.data.qvel[self._chair_dof: self._chair_dof + 6]
        return qv[:3].copy(), qv[3:6].copy()  # world linear, body angular

    def _eval(self):
        """push_chair.py:285-296 + the BaseEnv hysteresis."""
        lin, ang = self._chair_vels()
        dist = np.linalg.norm(self.data.xpos[self._chair_body][:2] - self.target_xy)
        flags = {
            "chair_close_to_target": bool(dist < self.target_radius),
            "chair_standing": bool(abs(self._chair_z_tilt()) < 0.05 * np.pi),
            "chair_static": bool(np.linalg.norm(lin) <= 0.1 and np.linalg.norm(ang) <= 0.2),
        }
        result = self._apply_hysteresis(flags)
        return result, result["success"]

    def _dense_reward(self, action):
        """Port of push_chair.py:215-283 compute_dense_reward."""
        ee_coords = self.agent.get_ee_coords()            # [4, 3] dual arm
        target_points = self._chair_points_world()

        dist_ee_actor = float(np.linalg.norm(
            ee_coords[:, None] - target_points[None], axis=-1).min(-1).mean())
        root_p = self.data.xpos[self._chair_body]
        dist_robotroot_actor = float(np.linalg.norm(
            self.agent.base_link_pos()[:2] - root_p[:2]))

        log_dist_ee_actor = np.log(dist_ee_actor + 1e-5)

        dist_pos = root_p[:2] - self.target_xy
        dist_pos_norm = float(np.linalg.norm(dist_pos))
        dist_ori = self._chair_z_tilt()

        lin, ang = self._chair_vels()
        actor_vel_norm = float(np.linalg.norm(lin))
        # scipy.spatial.distance.cosine(v, d) = 1 - cos(v, d)
        denom = max(np.linalg.norm(lin[:2]) * dist_pos_norm, 1e-9)
        actor_vel_dir = float(1.0 - np.dot(lin[:2], dist_pos) / denom)
        actor_ang_vel_norm = float(np.linalg.norm(ang))
        action_norm = float(np.linalg.norm(action))

        info = {
            "dist_ee_actor": dist_ee_actor,
            "dist_robotroot_actor": dist_robotroot_actor,
            "dist_pos": dist_pos_norm,
            "dist_ori": dist_ori,
            "actor_vel_norm": actor_vel_norm,
            "actor_vel_dir": actor_vel_dir,
            "action_norm": action_norm,
        }

        stage_reward = -10.0
        reward_scale = 2.0
        reward = (-dist_ee_actor * 1 - np.clip(log_dist_ee_actor, -10, 0) * 1
                  - dist_ori * 0.2 - action_norm * 1e-6)

        if dist_ori < 0.2 * np.pi:
            if dist_ee_actor < 0.1:
                stage_reward += 2
                if dist_pos_norm <= 0.15:
                    stage_reward += 2
                    reward += np.exp(-actor_vel_norm * 10) * 2
                    if actor_vel_norm <= 0.1 and actor_ang_vel_norm <= 0.2:
                        stage_reward += 2
                else:
                    reward_vel = (actor_vel_dir - 1) * actor_vel_norm
                    reward += (float(np.clip(1 - np.exp(-reward_vel), -1, np.inf)) * 2
                               - dist_pos_norm * 2)
        else:
            stage_reward -= 5

        reward += stage_reward
        info["stage_reward"] = stage_reward * reward_scale
        reward *= reward_scale
        return float(reward), info

    # ---------------------------------------------------------------- obs
    def _state(self) -> np.ndarray:
        return self.agent.get_obs(self.ego_mode)

    def _state_extras(self):
        """obs_mode='state' extras: chair root pose + eval flags (reference
        get_visual_state, push_chair.py:74-82)."""
        from ..mani.geometry import mat2quat

        p = self.data.xpos[self._chair_body].copy()
        q = mat2quat(self.data.xmat[self._chair_body].reshape(3, 3))
        lin, ang = self._chair_vels()
        dist = np.linalg.norm(p[:2] - self.target_xy)
        close = float(dist < self.target_radius)
        standing = float(abs(self._chair_z_tilt()) < 0.05 * np.pi)
        static = float(np.linalg.norm(lin) <= 0.1 and np.linalg.norm(ang) <= 0.2)
        return [p, q, np.array([close, standing, close * standing * static])]

    def _ego_anchor_xy(self) -> np.ndarray:
        return self.agent.base_link_pos()[:2]

    def get_env_state(self):
        return {"qpos": self.data.qpos.copy(), "qvel": self.data.qvel.copy(),
                "model_id": self.model_id}
