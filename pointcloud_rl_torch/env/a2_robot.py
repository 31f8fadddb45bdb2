# Copy of pointcloud_rl_tpu/env/a2_robot.py for the PyTorch port (that package's env imports JAX).
"""Mobile A2 robot (the benchmark's own arm) on MuJoCo.

Parity target: ``mani_skill/mani_skill/agent/agent.py`` — the ``Agent`` base
(URDF + YAML-built per-joint controller stack, agent.py:100-193),
``DummyMobileAgent`` (ego-frame base velocity commands + the mobile-base
observation layout, agent.py:323-430) and the ``MobileA2SingleArmAgent`` /
``MobileA2DualArmAgent`` finger/hand bindings (agent.py:533-660).  The robot
is built from the SNAPSHOT'S OWN assets: ``A2.urdf`` / ``A2_single.urdf``
(sciurus + franka meshes) and the controller specs in
``config_files/robots/mobile_a2_*.yml`` (with ``_include`` resolution).

MuJoCo mapping of the SAPIEN actuation model:

- SAPIEN joint drive ``set_drive_property(stiffness=0, damping=D)`` +
  ``set_drive_velocity_target(v)`` == a MuJoCo ``<velocity>`` actuator with
  ``kv=D`` (force = D * (v_target - qvel)); the YAML ``friction`` becomes
  joint frictionloss, the URDF ``<dynamics>`` stays as passive damping.
- ``balance_passive_force`` (agent.py:217-222) == writing the robot dofs'
  bias forces (gravity + coriolis) into ``qfrc_applied`` each sim step.
- Controllers (LPFilter / PID / velocity / position) are the repo's
  ``mani.controllers`` — identical math, driven at ``control_frequency``.

Known deviations (documented): finger-tip frames use the finger joint
anchor + child-body orientation (SAPIEN reads the joint's global pose);
ee velocities come from ``mj_objectVelocity`` of the finger links.
"""

from __future__ import annotations

import os
import os.path as osp
import re
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..mani.config_parser import load_task_config
from ..mani.controllers import PositionController, VelocityController, build_joint_controllers

ROBOT_ROOT = os.environ.get(
    "MANISKILL_ROBOT_ROOT", "/root/reference/mani_skill/mani_skill/assets/robot/sciurus"
)
ROBOT_CFG_ROOT = os.environ.get(
    "MANISKILL_ROBOT_CFG_ROOT",
    "/root/reference/mani_skill/mani_skill/assets/config_files/robots",
)

_VARIANTS = {
    "a2_single": ("mobile_a2_single_arm.yml", "A2_single.urdf", 1),
    "a2_dual": ("mobile_a2_dual_arm.yml", "A2.urdf", 2),
}


def robot_assets_available() -> bool:
    return osp.isdir(ROBOT_ROOT) and osp.isfile(osp.join(ROBOT_CFG_ROOT, "mobile_a2_dual_arm.yml"))


def load_robot_yaml(variant: str) -> dict:
    yml, _, _ = _VARIANTS[variant]
    return load_task_config(osp.join(ROBOT_CFG_ROOT, yml))


def a2_mjcf_parts(variant: str, yaml_cfg: dict) -> Tuple[List[ET.Element], ET.Element, List[ET.Element]]:
    """Compile the A2 URDF and return (asset meshes, robot root body element,
    actuator elements) for grafting into a scene XML.

    Actuators: one ``<velocity>`` per controllable joint with ``kv`` = the
    YAML drive damping, named ``act_<joint>`` in controllable-joint order.
    """
    import mujoco

    _, urdf_name, _ = _VARIANTS[variant]
    urdf_path = osp.join(ROBOT_ROOT, urdf_name)
    with open(urdf_path) as f:
        text = f.read()
    # absolutize mesh paths (MuJoCo's mesh cache keys on the path string;
    # same rationale as _urdf_to_mjcf_parts in mujoco_manipulation.py)
    text = re.sub(r'filename="(?!/)', f'filename="{ROBOT_ROOT}/', text)
    spec = mujoco.MjSpec.from_string(text)
    spec.compile()
    root = ET.fromstring(spec.to_xml())

    meshes = []
    for mesh in root.find("asset") or []:
        if mesh.tag == "mesh":
            f = mesh.get("file")
            if f and not f.startswith("/"):
                mesh.set("file", osp.join(ROBOT_ROOT, f))
            meshes.append(mesh)

    world = root.find("worldbody")
    bodies = [el for el in world if el.tag == "body"]
    assert len(bodies) == 1, f"expected one robot root body, got {len(bodies)}"
    robot_body = bodies[0]

    name2cfg = {j["name"]: j for j in yaml_cfg["joints"]}
    actuators = []
    for name in yaml_cfg["controllable_joints"]:
        jcfg = name2cfg[name]
        kv = float(jcfg["damping"])
        actuators.append(ET.Element("velocity", dict(
            name=f"act_{name}", joint=name, kv=f"{kv}",
        )))
    # joint frictionloss from the YAML friction (SAPIEN set_friction)
    for el in robot_body.iter():
        if el.tag == "joint" and el.get("name") in name2cfg:
            el.set("frictionloss", str(name2cfg[el.get("name")]["friction"]))
    return meshes, robot_body, actuators


class A2Robot:
    """Host-side A2 agent over a compiled MuJoCo scene.

    Binds by joint NAME, so it works inside any composed scene.  Call
    ``bind(model, data)`` after each scene compile, then drive it with
    ``set_action(normalized_action, ego_mode)`` once per control step and
    ``simulation_step()`` once per sim substep.
    """

    def __init__(self, variant: str = "a2_dual", control_freq: float = 100.0):
        assert variant in _VARIANTS, f"unknown robot variant {variant!r}"
        self.variant = variant
        self.cfg = load_robot_yaml(variant)
        self.num_ee = _VARIANTS[variant][2]
        self.control_freq = float(control_freq)
        name2cfg = {j["name"]: j for j in self.cfg["joints"]}
        self.controllable_joints: List[str] = list(self.cfg["controllable_joints"])
        self.all_joints: List[str] = list(self.cfg["all_joints"])
        self.initial_qpos = np.asarray(self.cfg["initial_qpos"], np.float64)
        self.controllers, self.action_range = build_joint_controllers(
            [name2cfg[n] for n in self.controllable_joints], self.control_freq
        )
        self.balance_passive_force = bool(self.cfg.get("balance_passive_force", True))
        if variant == "a2_dual":
            self._finger_joints = ["right_panda_finger_joint2", "right_panda_finger_joint1",
                                   "left_panda_finger_joint2", "left_panda_finger_joint1"]
            self._finger_signs = [1.0, -1.0, 1.0, -1.0]
        else:
            self._finger_joints = ["right_panda_finger_joint2", "right_panda_finger_joint1"]
            self._finger_signs = [1.0, -1.0]

    # ------------------------------------------------------------------ bind
    def bind(self, model, data) -> None:
        import mujoco

        self.model, self.data = model, data
        jid = lambda n: mujoco.mj_name2id(model, mujoco.mjtObj.mjOBJ_JOINT, n)
        self._jids = {n: jid(n) for n in self.all_joints}
        missing = [n for n, i in self._jids.items() if i < 0]
        assert not missing, f"robot joints missing from the scene: {missing}"
        self._qadr = np.array([model.jnt_qposadr[self._jids[n]] for n in self.all_joints])
        self._dadr = np.array([model.jnt_dofadr[self._jids[n]] for n in self.all_joints])
        self._ctrl_dadr = np.array(
            [model.jnt_dofadr[self._jids[n]] for n in self.controllable_joints]
        )
        self._ctrl_qadr = np.array(
            [model.jnt_qposadr[self._jids[n]] for n in self.controllable_joints]
        )
        aid = lambda n: mujoco.mj_name2id(model, mujoco.mjtObj.mjOBJ_ACTUATOR, f"act_{n}")
        self._act_ids = np.array([aid(n) for n in self.controllable_joints])
        assert (self._act_ids >= 0).all(), "robot actuators missing (a2_mjcf_parts adds them)"
        self._finger_jids = [jid(n) for n in self._finger_joints]
        self._finger_bodies = [model.jnt_bodyid[j] for j in self._finger_jids]
        # robot subtree = every body whose ancestor chain hits the root body
        # that owns root_x_axis_joint
        self._root_body = int(model.jnt_bodyid[self._jids["root_x_axis_joint"]])
        # walk up to the attachment body (child of world the robot hangs off)
        rb = self._root_body
        while model.body_parentid[rb] != 0:
            rb = model.body_parentid[rb]
        self._attach_body = rb
        self.robot_bodies = {
            b for b in range(model.nbody) if self._is_descendant(b, rb)
        }
        # "hand" links for visual-state / body link (agent.py:646).  MuJoCo's
        # URDF import welds fixed-jointed links, so ``panda_hand`` may not
        # survive as its own body — fall back to the finger joints' parent
        # body, which IS the hand weld.
        hand = [b for b in range(model.nbody)
                if "panda_hand" in (model.body(b).name or "")]
        if not hand:
            hand = sorted({int(model.body_parentid[model.jnt_bodyid[j]])
                           for j in self._finger_jids})
        self._hand_bodies = hand

    def _is_descendant(self, body: int, root: int) -> bool:
        m = self.model
        while body != 0:
            if body == root:
                return True
            body = m.body_parentid[body]
        return False

    # --------------------------------------------------------------- control
    def reset(self) -> None:
        self.data.qpos[self._qadr] = self.initial_qpos
        self.data.qvel[self._dadr] = 0.0
        for c in self.controllers:
            if hasattr(c, "reset"):
                c.reset()
            if getattr(c, "lp_filter", None) is not None:
                c.lp_filter.reset()

    def base_orientation(self) -> float:
        return float(self.data.qpos[self._qadr[2]])

    def scale_action(self, action: np.ndarray) -> np.ndarray:
        """[-1, 1] -> action_range (reference base_env.py:808-812)."""
        action = np.clip(np.asarray(action, np.float64), -1.0, 1.0)
        lo, hi = self.action_range[:, 0], self.action_range[:, 1]
        return 0.5 * (hi - lo) * action + 0.5 * (hi + lo)

    def set_action(self, action: np.ndarray, ego_mode: bool = False) -> None:
        """SCALED action (action_range units), once per control step
        (reference agent.py:205-216 + DummyMobileAgent.set_action:340-354)."""
        new_action = np.array(action, np.float64, copy=True)
        if ego_mode is not False:
            ego_xy = new_action[:2]
            ego_xy = ego_xy / max(np.linalg.norm(ego_xy), 1e-6) * np.abs(ego_xy).max() * 1.414
            th = self.base_orientation()
            rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
            new_action[:2] = rot @ ego_xy
        qpos = self.data.qpos
        qvel = self.data.qvel
        for k, (controller, target) in enumerate(zip(self.controllers, new_action)):
            if isinstance(controller, PositionController):
                out = controller.control(float(qpos[self._ctrl_qadr[k]]), float(target))
            else:
                out = controller.control(float(qvel[self._ctrl_dadr[k]]), float(target))
            self.data.ctrl[self._act_ids[k]] = out

    def simulation_step(self) -> None:
        """Gravity/coriolis compensation on the robot dofs (agent.py:217-222)."""
        if self.balance_passive_force:
            self.data.qfrc_applied[self._dadr] = self.data.qfrc_bias[self._dadr]

    # ------------------------------------------------------------------- obs
    def get_ee_coords(self) -> np.ndarray:
        """Finger-tip points, one pair per gripper (agent.py:573-581/634-640):
        joint anchor +- 0.035 along the finger body's local y."""
        out = []
        for jidx, sign in zip(self._finger_jids, self._finger_signs):
            bid = self.model.jnt_bodyid[jidx]
            R = self.data.xmat[bid].reshape(3, 3)
            out.append(self.data.xanchor[jidx] + R @ np.array([0.0, sign * 0.035, 0.0]))
        return np.array(out)

    def get_ee_coords_sample(self) -> np.ndarray:
        """[n_fingers, 10, 3] points sampled along each finger (reference
        agent.py:594-607 dual / 648-659 single): offsets
        x_i = (l*i + (4-i)*r)/4 along the finger body's local y from the
        joint anchor, signed per finger."""
        l, r = 0.0355, 0.052
        xs = np.array([(l * i + (4 - i) * r) / 4 for i in range(10)])
        out = []
        for jidx, sign in zip(self._finger_jids, self._finger_signs):
            bid = self.model.jnt_bodyid[jidx]
            ydir = self.data.xmat[bid].reshape(3, 3)[:, 1]
            out.append(self.data.xanchor[jidx][None] + (sign * xs)[:, None] * ydir[None])
        return np.array(out)

    def hand_pose(self):
        """World pose of the (first) panda hand link as a mani.geometry Pose
        (reference agent.hand.get_pose(), open_cabinet_door_drawer.py:320)."""
        from ..mani.geometry import Pose

        bid = self._hand_bodies[0]
        return Pose(self.data.xpos[bid].copy(), self.data.xquat[bid].copy())

    def hand_vel(self) -> np.ndarray:
        """World-frame linear velocity of the hand link."""
        import mujoco

        v6 = np.zeros(6)
        mujoco.mj_objectVelocity(self.model, self.data, mujoco.mjtObj.mjOBJ_BODY,
                                 self._hand_bodies[0], v6, 0)
        return v6[3:6]

    def get_ee_vels(self) -> np.ndarray:
        import mujoco

        out = []
        for jidx in self._finger_jids:
            bid = self.model.jnt_bodyid[jidx]
            v6 = np.zeros(6)
            mujoco.mj_objectVelocity(self.model, self.data, mujoco.mjtObj.mjOBJ_BODY, bid, v6, 0)
            out.append(v6[3:6])  # [ang, lin] -> linear part, world frame
        return np.array(out)

    def base_link_pos(self) -> np.ndarray:
        x, y = self.data.qpos[self._qadr[0]], self.data.qpos[self._qadr[1]]
        return np.array([x, y, 0.0])

    def _qpos_all(self) -> np.ndarray:
        return np.asarray(self.data.qpos[self._qadr], np.float64)

    def _qvel_all(self) -> np.ndarray:
        return np.asarray(self.data.qvel[self._dadr], np.float64)

    def get_obs(self, ego_mode: bool = False) -> np.ndarray:
        """The DummyMobileAgent observation layout (agent.py:369-433):
        concat[ee_pos, ee_vel, base_vel, base_ang_vel, qpos(arm), qvel(arm)]
        (+ base_pos, base_orientation appended when not ego_mode); with
        ego_mode the ee quantities rotate into the base frame."""
        qpos, qvel = self._qpos_all(), self._qvel_all()
        base_pos, base_orientation, arm_qpos = qpos[:2], qpos[2], qpos[3:]
        base_vel, base_ang_vel, arm_qvel = qvel[:2], qvel[2], qvel[3:]
        ee_pos = self.get_ee_coords().reshape(-1, 3)
        ee_vel = self.get_ee_vels().reshape(-1, 3)
        if ego_mode:
            th = base_orientation
            inv = np.array([
                [np.cos(-th), -np.sin(-th), 0.0],
                [np.sin(-th), np.cos(-th), 0.0],
                [0.0, 0.0, 1.0],
            ])
            ee_pos = ee_pos.copy()
            ee_pos[:, :2] -= base_pos
            ee_pos = ee_pos @ inv.T
            ee_vel = ee_vel @ inv.T
            base_vel = base_vel @ inv[:2, :2].T
            parts = [ee_pos.reshape(-1), ee_vel.reshape(-1), base_vel,
                     [base_ang_vel], arm_qpos, arm_qvel]
        else:
            parts = [ee_pos.reshape(-1), ee_vel.reshape(-1), base_vel,
                     [base_ang_vel], arm_qpos, arm_qvel, base_pos, [base_orientation]]
        return np.concatenate([np.atleast_1d(np.asarray(p, np.float64)) for p in parts]).astype(np.float32)

    # ----------------------------------------------------------------- state
    def get_state(self) -> Dict[str, np.ndarray]:
        """Mobile-agent state dict (agent.py:435-471 by_dict layout)."""
        qpos, qvel = self._qpos_all(), self._qvel_all()
        return {
            "ee_pos": self.get_ee_coords().reshape(-1),
            "ee_vel": self.get_ee_vels().reshape(-1),
            "base_pos": qpos[:2],
            "base_orientation": np.array([qpos[2]]),
            "base_vel": qvel[:2],
            "base_ang_vel": np.array([qvel[2]]),
            "qpos": qpos[3:],
            "qvel": qvel[3:],
        }

    def set_state(self, state: Dict[str, np.ndarray]) -> None:
        """Partial state update by dict (agent.py:474-504): base_pos /
        base_orientation / base_vel / base_ang_vel / qpos / qvel keys."""
        cur = self.get_state()
        cur.update({k: np.atleast_1d(np.asarray(v, np.float64)) for k, v in state.items()})
        qpos = np.concatenate([cur["base_pos"], cur["base_orientation"], cur["qpos"]])
        qvel = np.concatenate([cur["base_vel"], cur["base_ang_vel"], cur["qvel"]])
        self.data.qpos[self._qadr] = qpos
        self.data.qvel[self._dadr] = qvel
