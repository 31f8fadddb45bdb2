# Copy of pointcloud_rl_tpu/env/mujoco_manipulation.py for the PyTorch port (that package's env imports JAX).
"""Real-physics manipulation benchmark on MuJoCo with PartNet-Mobility assets.

The reference's ManiSkill tasks run on SAPIEN (C++/Vulkan), which this image
cannot ship.  The asset snapshot, however, contains the complete MoveBucket
object set (25 train + 4 val PartNet-Mobility buckets with hinge handles),
and MuJoCo loads their URDFs directly — so the MoveBucket task family
(reference ``mani_skill/mani_skill/env/move_bucket.py``) is rebuilt here on
MuJoCo with REAL contact physics, articulated assets, per-level object
sampling from the benchmark's own split files, multi-camera fused pointcloud
observations with segmentation masks, staged dense rewards, and the
reference's eval-flag protocol:

- scene: ground + sampled bucket (free base + handle hinge) with a ball
  inside + target platform + a floating parallel gripper (the reference
  drives a dual-arm mobile robot; a velocity-controlled floating gripper is
  the documented simplification — same task logic, fewer DoF);
- per-level variation: ``process_variants`` semantics over the real
  ``bucket_models_{train,val}.yml`` splits (model id + per-model scale),
  bucket/target placement from the level seed;
- observations: three cameras -> rgb/depth/segmentation -> unprojected and
  fused into one world-frame cloud -> seg-aware ``pcd_base`` downsample to
  {xyz, rgb, seg, state} exactly like the ManiSkill wrapper
  (maniskill_wrappers.py:142-199);
- eval flags with hysteresis (base_env.py:795-807):
  ball_in_bucket & bucket_above_platform & bucket_standing & bucket_static
  -> success (move_bucket.py:335-356);
- dense reward staged: reach handle -> lift -> move over target -> place
  (move_bucket.py:184-299 structure, built from mani.geometry helpers).

Action (6-d, [-1, 1]): gripper base velocity xyz + yaw rate + two finger
position targets, each DoF through a low-pass-filtered velocity controller
(mani.controllers) at the task control frequency.
"""

from __future__ import annotations

import os
import os.path as osp
import xml.etree.ElementTree as ET
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..mani.controllers import LPFilter
from ..mani.geometry import norm, normalize_and_clip_in_interval
from .mjc_task import MujocoTaskEnv
from .spaces import Box

ASSET_ROOT = os.environ.get("PARTNET_MOBILITY_ROOT", "/root/reference/partnet-mobility-dataset")
SPLIT_ROOT = os.environ.get(
    "MANISKILL_SPLIT_ROOT", "/root/reference/mani_skill/mani_skill/assets/config_files"
)


def _cosine_distance(a, b) -> float:
    """scipy.spatial.distance.cosine without scipy: 1 - cos-similarity."""
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na < 1e-12 or nb < 1e-12:
        return 1.0
    return float(1.0 - np.dot(a, b) / (na * nb))


def assets_available() -> bool:
    return osp.isdir(ASSET_ROOT) and osp.isfile(osp.join(SPLIT_ROOT, "bucket_models_train.yml"))


def load_bucket_split(split: str) -> Dict[str, dict]:
    """Model id -> {scale, ...} from the benchmark's own split files,
    filtered to locally present assets."""
    import yaml

    with open(osp.join(SPLIT_ROOT, f"bucket_models_{split}.yml")) as f:
        models = yaml.safe_load(f)
    out = {}
    for key, info in models.items():
        mid = str(info["partnet_mobility_id"])
        if osp.isdir(osp.join(ASSET_ROOT, mid)):
            out[mid] = info
    return out


def _urdf_to_mjcf_parts(model_dir: str) -> Tuple[List[ET.Element], List[ET.Element]]:
    """Compile a PartNet URDF with MuJoCo and return (asset meshes with
    absolute paths, worldbody children) for grafting into a scene.

    Uses the per-file MjSpec API, NOT mj_saveLastXML: the latter is
    process-global and, after a failed compile of one model, can hand back
    the FAILED parse's spec instead of the fallback's (observed as a
    mid-training worker crash on the repaired models)."""
    import mujoco

    def _spec_from(urdf_name: str):
        # Mesh paths are rewritten ABSOLUTE before parsing: MuJoCo's global
        # mesh cache keys on the path STRING, so the relative
        # "textured_objs/original-N.obj" collides across models — a cache
        # hit then skips the convex-hull validation and a model with a
        # degenerate mesh compiles here only to fail later in the composed
        # scene (observed as a mid-training worker crash).
        import re

        with open(osp.join(model_dir, urdf_name)) as f:
            text = f.read()
        text = re.sub(r'filename="(?!/)', f'filename="{model_dir}/', text)
        spec = mujoco.MjSpec.from_string(text)
        spec.compile()  # raises for degenerate (coplanar) collision meshes
        return spec

    try:
        spec = _spec_from("mobility.urdf")
    except ValueError:
        # the dataset ships a repaired variant for exactly those models
        # (4009, 4023: visual-only simplified geometry)
        spec = _spec_from("mobility_fixed.urdf")
    tree = ET.ElementTree(ET.fromstring(spec.to_xml()))
    root = tree.getroot()
    meshes = []
    for mesh in root.find("asset") or []:
        if mesh.tag == "mesh":
            mesh.set("file", osp.join(model_dir, mesh.get("file")))
            meshes.append(mesh)
    body_children = list(root.find("worldbody"))
    return meshes, body_children


_SCENE_TEMPLATE = """
<mujoco model="move_bucket">
  <compiler angle="radian"/>
  <option timestep="{timestep}" integrator="implicitfast"/>
  <visual>
    <!-- single-sample offscreen render + no shadow maps: ~4x cheaper on
         software GL, and MSAA-resolved depth is wrong for pointclouds
         (averaged depths at silhouettes) — same rationale as DMCEnv -->
    <quality offsamples="0" shadowsize="0"/>
  </visual>
  <asset>
    <texture type="2d" name="grid" builtin="checker" rgb1=".2 .3 .4" rgb2=".1 .15 .2" width="64" height="64"/>
    <material name="grid" texture="grid" texrepeat="4 4" reflectance="0"/>
  </asset>
  <worldbody>
    <light pos="1 1 3" dir="-0.3 -0.3 -1" diffuse="0.9 0.9 0.9" castshadow="false"/>
    <light pos="-2 0 3" dir="0.5 0 -1" diffuse="0.5 0.5 0.5" castshadow="false"/>
    <geom name="ground" type="plane" size="6 6 0.1" material="grid" friction="0.5 0.005 0.0001"/>
    <camera name="cam0" pos="1.6 0.0 1.3" xyaxes="0 1 0  -0.55 0 0.83"/>
    <camera name="cam1" pos="-0.8 1.4 1.3" xyaxes="-0.87 -0.5 0  0.33 -0.57 0.75"/>
    <camera name="cam2" pos="-0.8 -1.4 1.3" xyaxes="0.87 -0.5 0  0.33 0.57 0.75"/>
    <body name="platform" pos="{plat_x} {plat_y} {plat_hh}">
      <geom name="platform_geom" type="box" size="{plat_r} {plat_r} {plat_hh}" rgba="0.2 0.7 0.2 1" friction="0.5 0.005 0.0001"/>
    </body>
    <body name="ball" pos="{ball_x} {ball_y} {ball_z}">
      <freejoint name="ball_root"/>
      <geom name="ball_geom" type="sphere" size="0.03" density="300" rgba="0.9 0.7 0.1 1"/>
    </body>
  </worldbody>
  <actuator/>
</mujoco>
"""

_GRIPPER_BODY = """
    <body name="gripper" pos="{grip_x} {grip_y} {grip_z}">
      <joint name="grip_x" type="slide" axis="1 0 0" damping="20"/>
      <joint name="grip_y" type="slide" axis="0 1 0" damping="20"/>
      <joint name="grip_z" type="slide" axis="0 0 1" damping="20"/>
      <joint name="grip_yaw" type="hinge" axis="0 0 1" damping="5"/>
      <geom name="palm" type="box" size="0.10 0.02 0.02" density="2000" rgba="0.2 0.2 0.9 1"/>
      <body name="finger_l" pos="0.09 0 -0.05">
        <joint name="grip_fl" type="slide" axis="1 0 0" range="-0.07 0.0" damping="10"/>
        <geom name="finger_l_geom" type="box" size="0.012 0.02 0.06" density="2000"
              rgba="0.3 0.3 1 1" friction="2.0 0.01 0.0001"/>
      </body>
      <body name="finger_r" pos="-0.09 0 -0.05">
        <joint name="grip_fr" type="slide" axis="1 0 0" range="0.0 0.07" damping="10"/>
        <geom name="finger_r_geom" type="box" size="0.012 0.02 0.06" density="2000"
              rgba="0.3 0.3 1 1" friction="2.0 0.01 0.0001"/>
      </body>
    </body>
"""

_GRIPPER_ACTUATORS = """
  <actuator>
    <velocity name="act_x" joint="grip_x" kv="60" ctrlrange="-1 1" forcerange="-60 60"/>
    <velocity name="act_y" joint="grip_y" kv="60" ctrlrange="-1 1" forcerange="-60 60"/>
    <velocity name="act_z" joint="grip_z" kv="60" ctrlrange="-1 1" forcerange="-80 80"/>
    <velocity name="act_yaw" joint="grip_yaw" kv="10" ctrlrange="-2 2" forcerange="-20 20"/>
    <position name="act_fl" joint="grip_fl" kp="200" ctrlrange="-0.07 0" forcerange="-40 40"/>
    <position name="act_fr" joint="grip_fr" kp="200" ctrlrange="0 0.07" forcerange="-40 40"/>
  </actuator>
"""


def build_move_bucket_xml(model_dir: str, scale: float, plat_xy, bucket_xy,
                          timestep: float = 0.004, robot: str = "gripper") -> str:
    """Compose the scene: graft the bucket URDF (scaled, free base) into the
    template with ground/platform/ball/cameras, plus either the floating
    gripper or the benchmark's own mobile A2 robot (a2_robot.py)."""
    meshes, children = _urdf_to_mjcf_parts(model_dir)
    root = ET.fromstring(_SCENE_TEMPLATE.format(
        timestep=timestep,
        plat_x=plat_xy[0], plat_y=plat_xy[1], plat_r=0.25, plat_hh=0.05,
        ball_x=bucket_xy[0], ball_y=bucket_xy[1], ball_z=0.35,
    ))
    asset = root.find("asset")
    for mesh in meshes:
        mesh.set("scale", f"{scale} {scale} {scale}")
        asset.append(mesh)
    world = root.find("worldbody")
    if robot == "gripper":
        world.append(ET.fromstring(_GRIPPER_BODY.format(
            grip_x=bucket_xy[0], grip_y=bucket_xy[1], grip_z=0.9)))
        act = ET.fromstring(_GRIPPER_ACTUATORS)
        root.remove(root.find("actuator"))
        root.append(act)
    else:
        from .a2_robot import a2_mjcf_parts, load_robot_yaml

        rb_meshes, rb_body, rb_acts = a2_mjcf_parts(robot, load_robot_yaml(robot))
        for mesh in rb_meshes:
            asset.append(mesh)
        world.append(rb_body)
        actuator = root.find("actuator")
        for a in rb_acts:
            actuator.append(a)
        # The torso column (adjustable_body) spans the full height-joint
        # travel and spawns intersecting the ground; the reference ignores
        # that pair explicitly (agent.py:529 `gs[2] |= 1 << 30  # ignore
        # collision with ground`).  The ground plane lives on the world
        # body, so excluding the body pair is the exact MuJoCo equivalent.
        contact = ET.SubElement(root, "contact")
        ET.SubElement(contact, "exclude", dict(body1="adjustable_body", body2="world"))
    bucket = ET.SubElement(world, "body", dict(name="bucket",
                                               pos=f"{bucket_xy[0]} {bucket_xy[1]} 0.35"))
    ET.SubElement(bucket, "freejoint", dict(name="bucket_root"))
    for child in children:
        # scale body/geom offsets along with the meshes (iter() includes the
        # element itself — don't visit it twice or offsets scale by scale^2)
        for el in child.iter():
            pos = el.get("pos")
            if pos:
                el.set("pos", " ".join(str(float(v) * scale) for v in pos.split()))
        if child.tag == "geom":
            child.set("density", "400")
            child.set("friction", "0.5 0.005 0.0001")
        bucket.append(child)
    return ET.tostring(root, encoding="unicode")


class MoveBucketEnv(MujocoTaskEnv):
    """MoveBucket on MuJoCo (reference move_bucket.py semantics, floating
    parallel gripper).  Registered env names:
    ``MoveBucketMJC_train-v0`` / ``MoveBucketMJC_val-v0``."""

    def __init__(
        self,
        split: str = "train",
        obs_mode: str = "pointcloud",
        n_points: int = 1200,
        image_hw: Tuple[int, int] = (64, 112),
        horizon: int = 200,
        frame_skip: int = 10,
        control_freq: float = 25.0,
        target_radius: float = 0.25,
        keep_good_steps_threshold: int = 3,
        reward_type: str = "dense",
        max_depth: float = 6.0,
        ego_mode: bool = False,
        robot: str = "a2_dual",
        bucket_dist_range: Tuple[float, float] = (0.8, 1.2),
        **kwargs,
    ):
        """``robot``: "a2_dual" (default — the benchmark's own mobile A2
        dual-arm agent, reference move_bucket.yml + agent.py:533-610),
        "a2_single", or "gripper" (the round-2 floating-gripper
        simplification, kept for old work dirs).

        A2 timing: sim dt 0.004 (250 Hz), controllers at 50 Hz (reference:
        500/100 Hz — halved to keep one-core host stepping affordable),
        2 control steps per env step -> 25 Hz env, same as the gripper."""
        assert assets_available(), (
            f"MoveBucketMJC needs the PartNet-Mobility snapshot at {ASSET_ROOT} "
            f"and split files at {SPLIT_ROOT} (set PARTNET_MOBILITY_ROOT / "
            "MANISKILL_SPLIT_ROOT)"
        )
        self.split_models = load_bucket_split(split)
        assert self.split_models, f"no local models for split {split!r}"
        self.obs_mode = obs_mode
        self.n_points = n_points
        self.image_hw = tuple(image_hw)
        self.horizon = horizon
        self.frame_skip = frame_skip
        self.control_freq = control_freq
        self.target_radius = target_radius
        self.keep_good_steps_threshold = keep_good_steps_threshold
        self.reward_type = reward_type
        self.max_depth = max_depth
        self.ego_mode = ego_mode
        self.robot = robot
        # Carry-curriculum knob (same rationale as PushChair's
        # robot_init_range, chair_task.py:209): the reference spawns the
        # target platform 0.8-1.2 m from the bucket (move_bucket.py:77-113,
        # the default here).  Short training budgets can shrink the carry
        # distance so the lift->place->release tail of the staged ladder is
        # reachable; success semantics (ball in bucket AND above platform
        # AND standing AND static, with hysteresis) are unchanged.
        self.bucket_dist_range = (float(bucket_dist_range[0]), float(bucket_dist_range[1]))
        if robot == "gripper":
            self.agent = None
            self.action_space = Box(-1.0, 1.0, (6,))
        else:
            from .a2_robot import A2Robot, robot_assets_available

            assert robot_assets_available(), "A2 robot assets/configs not found"
            # 50 Hz controllers, 5 sim substeps each, 2 control steps/env step
            self.n_sim_per_control = 5
            self.ctrl_per_step = 2
            self.agent = A2Robot(robot, control_freq=1.0 / (0.004 * self.n_sim_per_control))
            self.action_space = Box(-1.0, 1.0, (len(self.agent.controllable_joints),))
        self.np_random = np.random.RandomState()
        self._renderers = None
        self.model = None
        self._step_count = 0
        self.keep_good_steps = defaultdict(int)

    # ------------------------------------------------------------- scene
    def _compiled(self, model_id: str, scale: float):
        # No model caching: platform/bucket placement is baked into the XML
        # (continuous samples, so a placement-keyed cache would never hit),
        # and MuJoCo's global mesh cache already cost one round-2 crash.
        import mujoco

        xml = build_move_bucket_xml(osp.join(ASSET_ROOT, model_id), scale,
                                    self._plat_xy, self._bucket_xy, robot=self.robot)
        return mujoco.MjModel.from_xml_string(xml)

    def reset(self, level: Optional[int] = None, **kwargs):
        import mujoco

        if level is not None:
            self.np_random.seed(int(level))
        rs = self.np_random
        self._step_count = 0
        self._reset_hysteresis()

        # per-level variant sampling: model id + its split-file scale
        # (reference process_variants over bucket_models_*.yml)
        ids = sorted(self.split_models)
        model_id = ids[int(rs.randint(len(ids)))]
        scale = float(self.split_models[model_id].get("scale", 1.0))
        # target platform and bucket placement (move_bucket.py:77-113;
        # the layout is the reference's translated so the BUCKET starts
        # near the origin: bucket->target distance 0.8-1.2 m)
        ang = rs.uniform(-np.pi, np.pi)
        dist = rs.uniform(*self.bucket_dist_range)
        self._plat_xy = np.array([np.cos(ang), np.sin(ang)]) * dist
        self._bucket_xy = rs.uniform(-0.15, 0.15, 2)

        self.model = self._compiled(model_id, scale)
        self.data = mujoco.MjData(self.model)
        self.model_id = model_id
        self._name_ids()
        self._renderers = None  # lazily rebuilt per model

        if self.agent is None:
            # low-pass filters for the gripper base velocity command
            self._vel_filters = [LPFilter(self.control_freq, 8.0) for _ in range(4)]
        else:
            self.agent.bind(self.model, self.data)
            self.agent.reset()
            # robot placement (move_bucket.py:115-139): 0.6-0.8 m from the
            # bucket, on the side away from the target, facing the bucket
            to_bucket_theta = ang + np.pi  # direction target -> bucket
            theta = to_bucket_theta + rs.uniform(-0.4 * np.pi, 0.4 * np.pi)
            rdist = rs.uniform(0.6, 0.8)
            base_pos = self._bucket_xy + np.array([np.cos(theta), np.sin(theta)]) * rdist
            base_theta = -np.pi + theta + rs.uniform(-0.05 * np.pi, 0.05 * np.pi)
            self.agent.set_state({"base_pos": base_pos, "base_orientation": base_theta})

        # drop the bucket onto the ground and let it settle
        mujoco.mj_forward(self.model, self.data)
        lowest = self._bucket_lowest_z()
        self.data.qpos[self._bucket_qpos + 2] -= lowest - 0.005
        for _ in range(100):
            if self.agent is not None:
                self.agent.simulation_step()
            mujoco.mj_step(self.model, self.data)
        # ball into the bucket interior, then settle again
        center = self.data.xpos[self._bucket_body].copy()
        self.data.qpos[self._ball_qpos : self._ball_qpos + 3] = center + [0, 0, 0.05]
        self.data.qvel[:] = 0
        for _ in range(100):
            if self.agent is not None:
                self.agent.simulation_step()
            mujoco.mj_step(self.model, self.data)
        if self.agent is not None:
            # staged-reward reference quantities (move_bucket.py:88-113)
            mujoco.mj_forward(self.model, self.data)
            self._bucket_surface_cache = self._bucket_surface_points()
            bb = self._bucket_local_bbox()
            self._bb_local = bb
            self._bucket_center_offset = (bb[1, 2] - bb[0, 2]) / 5
            self._init_bucket_height = float(self.data.xipos[self._bucket_body][2])
        return self.get_obs()

    def _name_ids(self):
        import mujoco

        m = self.model
        name2body = lambda n: mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_BODY, n)
        self._bucket_body = name2body("bucket")
        self._gripper_body = name2body("gripper")  # -1 under the A2 robot
        self._ball_body = name2body("ball")
        self._platform_body = name2body("platform")
        jid = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_JOINT, "bucket_root")
        self._bucket_qpos = m.jnt_qposadr[jid]
        self._bucket_dof = m.jnt_dofadr[jid]
        jid = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_JOINT, "ball_root")
        self._ball_qpos = m.jnt_qposadr[jid]
        if self.agent is None:
            self._grip_dofs = [
                m.jnt_dofadr[mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_JOINT, n)]
                for n in ("grip_x", "grip_y", "grip_z", "grip_yaw", "grip_fl", "grip_fr")
            ]
        # geom groups for segmentation masks: bucket subtree split into
        # handle (hinged child bodies) vs body, and the gripper subtree
        bucket_bodies, handle_bodies, robot_bodies = set(), set(), set()

        def subtree(root):
            out = {root}
            for b in range(m.nbody):
                parent = m.body_parentid[b]
                if parent in out and b != root:
                    out.add(b)
            return out

        bucket_tree = subtree(self._bucket_body)
        for b in bucket_tree:
            # hinged descendants (the handle) have their own joints
            if b != self._bucket_body and m.body_jntnum[b] > 0:
                handle_bodies |= subtree(b)
        bucket_bodies = bucket_tree - handle_bodies
        if self.agent is None:
            robot_bodies = subtree(self._gripper_body)
        else:
            # agent.bind happens after _name_ids; compute the subtree here
            jid_rx = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_JOINT, "root_x_axis_joint")
            rb = int(m.jnt_bodyid[jid_rx])
            while m.body_parentid[rb] != 0:
                rb = m.body_parentid[rb]
            robot_bodies = subtree(rb)
        self._handle_body = next(iter(handle_bodies)) if handle_bodies else self._bucket_body

        def geoms_of(bodies):
            return {g for g in range(m.ngeom) if m.geom_bodyid[g] in bodies}

        self._seg_geoms = [geoms_of(handle_bodies), geoms_of(bucket_bodies), geoms_of(robot_bodies)]

    def _bucket_lowest_z(self) -> float:
        """Approximate the bucket subtree's lowest point from geom AABBs."""
        m, d = self.model, self.data
        lows = []
        for g in range(m.ngeom):
            b = m.geom_bodyid[g]
            if b and self._in_subtree(b, self._bucket_body):
                lows.append(d.geom_xpos[g][2] - float(np.linalg.norm(m.geom_rbound[g])))
        return min(lows) if lows else 0.0

    def _bucket_geoms(self) -> List[int]:
        m = self.model
        return [g for g in range(m.ngeom)
                if m.geom_bodyid[g] and self._in_subtree(m.geom_bodyid[g], self._bucket_body)]

    def _bucket_surface_points(self, per_geom: int = 128):
        """Sampled bucket surface points in GEOM-LOCAL frames (reference
        _load_bucket_pcds samples 512/link from the visual meshes); returns
        [(geom_id, [K, 3] local points), ...] transformed per step."""
        import mujoco  # noqa: F401

        m = self.model
        rs = self.np_random
        out = []
        for g in self._bucket_geoms():
            if m.geom_type[g] == 7:  # mjGEOM_MESH
                mid = m.geom_dataid[g]
                v0, nv = m.mesh_vertadr[mid], m.mesh_vertnum[mid]
                verts = m.mesh_vert[v0:v0 + nv].reshape(-1, 3)
                take = rs.choice(len(verts), size=min(per_geom, len(verts)), replace=False)
                out.append((g, np.asarray(verts[take], np.float64)))
        return out

    def _bucket_points_world(self) -> np.ndarray:
        d = self.data
        pts = []
        for g, local in self._bucket_surface_cache:
            R = d.geom_xmat[g].reshape(3, 3)
            pts.append(local @ R.T + d.geom_xpos[g])
        return np.concatenate(pts, 0) if pts else np.zeros((1, 3))

    def _bucket_local_bbox(self) -> np.ndarray:
        """AABB of the bucket geometry in the bucket BODY frame (reference
        bb_local, move_bucket.py:92-94) — the balls-in-bucket test volume."""
        d = self.data
        Rb = d.xmat[self._bucket_body].reshape(3, 3)
        ob = d.xpos[self._bucket_body]
        pts = (self._bucket_points_world() - ob) @ Rb
        return np.stack([pts.min(0), pts.max(0)])

    # ------------------------------------------------------------- stepping
    def step(self, action):
        import mujoco

        action = np.clip(np.asarray(action, np.float32), -1, 1)
        if self.agent is None:
            # floating gripper: base velocities through low-pass velocity
            # controllers; fingers are position targets (open..closed)
            vel_scale = np.array([0.6, 0.6, 0.6, 1.5])
            for i in range(4):
                self.data.ctrl[i] = self._vel_filters[i].next(float(action[i]) * vel_scale[i])
            self.data.ctrl[4] = -(action[4] * 0.5 + 0.5) * 0.07
            self.data.ctrl[5] = (action[5] * 0.5 + 0.5) * 0.07
            for _ in range(self.frame_skip):
                mujoco.mj_step(self.model, self.data)
        else:
            self._step_agent(action)
        self._step_count += 1

        eval_info, success = self._eval()
        if self.agent is None:
            reward, rew_info = self._dense_reward()
        else:
            reward, rew_info = self._dense_reward_a2(action)
        if self.reward_type == "sparse":
            reward = float(success)
        done = bool(success or self._step_count >= self.horizon)
        info = {"success": success, "eval_info": eval_info, **rew_info}
        if done and not success:
            info["TimeLimit.truncated"] = True
        return self.get_obs(), float(reward), done, info

    # ------------------------------------------------------------ eval/rew
    def _bucket_tilt(self) -> float:
        """Angle between the bucket z-axis and world up, folded into
        [0, pi/2] via abs(dot) like the reference angle_between_vec
        (utils/geometry.py:43-47; move_bucket.py:236,351)."""
        R = self.data.xmat[self._bucket_body].reshape(3, 3)
        cosang = float(np.clip(abs(R[2, 2]), 0.0, 1.0))
        return float(np.arccos(cosang))

    def _eval(self):
        d = self.data
        bucket_xy = d.xpos[self._bucket_body][:2]
        ball = d.xpos[self._ball_body]
        bucket = d.xpos[self._bucket_body]
        if self.agent is not None:
            # reference test (move_bucket.py:328-337): ball inside the
            # bucket-body-frame AABB of the bucket geometry
            p_local = d.xmat[self._bucket_body].reshape(3, 3).T @ (ball - bucket)
            in_bucket = bool(np.all(p_local > self._bb_local[0])
                             and np.all(p_local < self._bb_local[1]))
        else:
            in_bucket = bool(np.linalg.norm(ball[:2] - bucket_xy) < 0.35 and ball[2] > 0.0)
        flags = {
            "ball_in_bucket": in_bucket,
            "bucket_above_platform": bool(norm(bucket_xy - self._plat_xy) < self.target_radius),
            "bucket_standing": bool(self._bucket_tilt() < 0.1 * np.pi),
            "bucket_static": bool(
                np.abs(d.qvel[self._bucket_dof : self._bucket_dof + 3]).max() < 0.1
                and np.abs(d.qvel[self._bucket_dof + 3 : self._bucket_dof + 6]).max() < 0.2
            ),
        }
        result = self._apply_hysteresis(flags)
        return result, result["success"]

    def _dense_reward(self):
        """Staged shaping (move_bucket.py:184-299 structure): reach the
        handle, keep the bucket upright, carry it over the target, settle."""
        d = self.data
        grip = d.xpos[self._gripper_body]
        handle = d.xpos[self._handle_body]
        bucket = d.xpos[self._bucket_body]
        dist_reach = float(norm(grip - handle))
        rew_reach = 1.0 - normalize_and_clip_in_interval(dist_reach, 0.0, 1.0)
        dist_target = float(norm(bucket[:2] - self._plat_xy))
        rew_move = 1.5 * (1.0 - normalize_and_clip_in_interval(dist_target, 0.0, 1.5))
        rew_up = 0.5 * (1.0 - normalize_and_clip_in_interval(self._bucket_tilt(), 0.0, np.pi / 2))
        # placement bonus once over the platform and standing
        bonus = 0.0
        if dist_target < self.target_radius and self._bucket_tilt() < 0.1 * np.pi:
            bonus = 1.0
        reward = rew_reach + rew_move + rew_up + bonus - 1.5
        return reward, {"dist_reach": dist_reach, "dist_target": dist_target}

    def _dense_reward_a2(self, action):
        """Faithful port of the reference staged reward
        (move_bucket.py:184-299) on the A2 agent: approach both grippers to
        the bucket surface, oppose the arms around the body, lift ~0.2 m,
        carry toward the target, then settle — with the same log-distance
        shaping, stage ladder (-20 base, +2 per stage) and tipping penalty."""
        d = self.data
        ee_coords = self.agent.get_ee_coords()          # [2*num_ee, 3]
        ee_vels = self.agent.get_ee_vels()
        ee_mids = np.array([ee_coords[:2].mean(0), ee_coords[2:].mean(0)]) \
            if len(ee_coords) == 4 else np.array([ee_coords.mean(0), ee_coords.mean(0)])

        target_points = self._bucket_points_world()
        dists = np.sqrt(((ee_coords[:, None] - target_points[None]) ** 2).sum(-1)).min(-1)
        dist_ee_actor = float(dists.mean())
        log_dist_ee_actor = np.log(dist_ee_actor + 1e-5)
        dist_robotroot_actor = float(np.linalg.norm(
            self.agent.base_link_pos()[:2] - d.xpos[self._bucket_body][:2]))

        Rb = d.xmat[self._bucket_body].reshape(3, 3)
        bucket_mid = d.xipos[self._bucket_body].copy()
        bucket_mid[2] += self._bucket_center_offset
        v1, v2 = ee_mids[0] - bucket_mid, ee_mids[1] - bucket_mid
        ees_oppo = float(_cosine_distance(v1, v2))
        ees_height_diff = float(abs((Rb.T @ (ee_mids[0] - ee_mids[1]))[2]))
        log_ees_height_diff = np.log(ees_height_diff + 1e-5)

        rel_vels = []
        com = d.xipos[self._bucket_body]
        v_lin = d.qvel[self._bucket_dof: self._bucket_dof + 3]
        w = d.qvel[self._bucket_dof + 3: self._bucket_dof + 6]
        for p, pv in zip(ee_coords, ee_vels):
            rel_vels.append(np.cross(w, p - com) + v_lin - pv)
        rel_vel_ee_actor_norm = float(np.linalg.norm(rel_vels, axis=-1).mean())

        dist_pos = d.xpos[self._bucket_body][:2] - self._plat_xy
        dist_pos_norm = float(np.linalg.norm(dist_pos))
        bucket_height = float(d.xipos[self._bucket_body][2])
        dist_bucket_height = abs(bucket_height - self._init_bucket_height - 0.2)
        z_axis_bucket = Rb @ np.array([0.0, 0.0, 1.0])
        # angle_between_vec folds via abs(dot) into [0, pi/2]
        # (reference utils/geometry.py:43-47, used at move_bucket.py:236).
        dist_ori = float(np.arccos(np.clip(abs(z_axis_bucket[2]), 0.0, 1.0)))
        log_dist_ori = np.log(dist_ori + 1e-12)

        actor_vel_norm = float(np.linalg.norm(v_lin))
        actor_vel_dir = float(_cosine_distance(v_lin[:2], dist_pos))
        actor_ang_vel_norm = float(np.linalg.norm(w))
        actor_vel_up = float(v_lin[2])
        action_norm = float(np.linalg.norm(action))

        stage_reward = -20.0
        reward = (
            -dist_ee_actor * 1
            - float(np.clip(log_dist_ee_actor, -10, 0)) * 1
            - dist_ori * 0.2
            - float(np.clip(log_ees_height_diff, -10, 0)) * 0.2
            - action_norm * 1e-6
        )
        if dist_ee_actor < 0.1:
            stage_reward += 2
            reward += ees_oppo * 2
            if dist_bucket_height < 0.03:
                stage_reward += 2
                reward -= float(np.clip(log_dist_ori, -4, 0))
                if dist_pos_norm <= 0.3:
                    stage_reward += 2
                    reward += np.exp(-actor_vel_norm * 10) * 2
                    if actor_vel_norm <= 0.1 and actor_ang_vel_norm <= 0.2:
                        stage_reward += 2
                        if dist_ori <= 0.1 * np.pi:
                            stage_reward += 2
                else:
                    reward_vel = (actor_vel_dir - 1) * actor_vel_norm
                    reward += float(np.clip(1 - np.exp(-reward_vel), -1, np.inf)) * 2 - dist_pos_norm * 2
            else:
                reward += float(np.clip(1 - np.exp(-actor_vel_up), -1, np.inf)) * 2 - dist_bucket_height * 20
        if dist_ori > 0.4 * np.pi:
            stage_reward -= 2
        reward += stage_reward
        info = {
            "dist_ee_actor": dist_ee_actor,
            "dist_robotroot_actor": dist_robotroot_actor,
            "dist_pos": dist_pos_norm,
            "dist_ori": dist_ori,
            "bucket_height": bucket_height,
            "ees_oppo": ees_oppo,
            "ees_height_diff": ees_height_diff,
            "actor_vel_up": actor_vel_up,
            "actor_vel_norm": actor_vel_norm,
            "rel_vel_ee_actor_norm": rel_vel_ee_actor_norm,
            "stage_reward": stage_reward,
        }
        return float(reward), info

    # ---------------------------------------------------------------- obs
    def _state(self) -> np.ndarray:
        if self.agent is not None:
            # the reference's obs "state" is the agent state alone
            # (base_env.py get_obs -> agent.get_obs(ego_mode), agent.py:369)
            return self.agent.get_obs(self.ego_mode)
        d = self.data
        grip = d.xpos[self._gripper_body]
        qvel_grip = d.qvel[self._grip_dofs]
        fingers = d.ctrl[4:6]
        return np.concatenate([
            grip, d.xmat[self._gripper_body].reshape(9)[:6], qvel_grip, fingers,
            np.asarray(self._plat_xy, np.float64), [self._step_count / max(self.horizon, 1)],
        ]).astype(np.float32)

    def _state_extras(self):
        d = self.data
        return [d.xpos[self._bucket_body], d.xpos[self._ball_body],
                d.xpos[self._handle_body]]

    def _ego_anchor_xy(self) -> np.ndarray:
        return self.data.xpos[self._gripper_body][:2]

    def get_env_state(self):
        return {"qpos": self.data.qpos.copy(), "qvel": self.data.qvel.copy(),
                "model_id": self.model_id, "plat_xy": np.asarray(self._plat_xy)}
