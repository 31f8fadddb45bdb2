# Copy of pointcloud_rl_tpu/mani/osc.py for the PyTorch port, which imports nothing of that package.
"""Operational-space control interface for the mobile A2 robots.

Parity target: ``mani_skill/mani_skill/utils/osc.py:47-177`` — decompose a
joint-space velocity action into (operational-space 6-D hand twist per arm +
base/finger extras) and a null-space component, and recompose; used to drive
the end effector along task-frame directions while the redundant arm dofs
move in the Jacobian null space.

The reference builds SAPIEN+pinocchio models of the fixed-base arm URDFs
(``A2_left.urdf`` / ``A2_right.urdf``) and uses the hand link's LOCAL
jacobian; here the same URDFs are compiled with MuJoCo and the local
jacobian comes from ``mj_jacBody`` rotated into the hand frame
(rows ordered [linear; angular], pinocchio's convention).  The OSC math
(``nullspace_method`` least-squares, scipy ``null_space`` projection) is
identical.
"""

from __future__ import annotations

import os.path as osp
from typing import List

import numpy as np

from ..env.a2_robot import ROBOT_CFG_ROOT, ROBOT_ROOT

_ARM_URDFS = {"left": "A2_left.urdf", "right": "A2_right.urdf"}


def nullspace_method(J, delta, regularization_strength: float = 0.0):
    """Least-squares solve of J X = delta (reference osc.py:9-19)."""
    hess_approx = J.T.dot(J)
    joint_delta = J.T.dot(delta)
    if regularization_strength > 0:
        hess_approx += np.eye(hess_approx.shape[0]) * regularization_strength
        return np.linalg.solve(hess_approx, joint_delta)
    return np.linalg.lstsq(hess_approx, joint_delta, rcond=-1)[0]


def _load_controllable_joints(variant_yaml: str) -> List[str]:
    import yaml

    with open(osp.join(ROBOT_CFG_ROOT, variant_yaml)) as f:
        return yaml.safe_load(f)["controllable_joints"]


class _ArmModel:
    """Fixed-base 7-dof panda arm compiled from the snapshot's URDF."""

    def __init__(self, side: str):
        import mujoco

        self._mujoco = mujoco
        spec = mujoco.MjSpec.from_file(osp.join(ROBOT_ROOT, _ARM_URDFS[side]))
        # keep the fixed-jointed hand link as its own body (MuJoCo's URDF
        # importer would otherwise weld it into link7 and drop the name)
        spec.compiler.fusestatic = False
        self.model = spec.compile()
        self.data = mujoco.MjData(self.model)
        self.joint_names = [self.model.joint(i).name for i in range(self.model.njnt)]
        hand = f"{side}_panda_hand"
        self.hand_bid = mujoco.mj_name2id(self.model, mujoco.mjtObj.mjOBJ_BODY, hand)
        assert self.hand_bid >= 0, f"hand link {hand} missing in {_ARM_URDFS[side]}"

    def local_jacobian_T(self, qpos: np.ndarray) -> np.ndarray:
        """[nv, 6] transposed hand-frame jacobian (reference get_J —
        pinocchio compute_single_link_local_jacobian(...).T)."""
        m, d, mujoco = self.model, self.data, self._mujoco
        d.qpos[:] = qpos
        mujoco.mj_kinematics(m, d)
        mujoco.mj_comPos(m, d)
        jacp = np.zeros((3, m.nv))
        jacr = np.zeros((3, m.nv))
        mujoco.mj_jacBody(m, d, jacp, jacr, self.hand_bid)
        R = d.xmat[self.hand_bid].reshape(3, 3)
        local = np.concatenate([R.T @ jacp, R.T @ jacr], axis=0)  # [6, nv]
        return local.T


class OperationalSpaceControlInterface:
    """Reference osc.py:47 surface: osc_dim = extras + 6 per arm; the
    control signal is a 6-D velocity relative to each robot hand."""

    def __init__(self, env_name: str):
        if "MoveBucket" in env_name or "PushChair" in env_name:
            self.n_arms = 2
            joint_names = _load_controllable_joints("mobile_a2_dual_arm.yml")
        elif "Cabinet" in env_name:
            self.n_arms = 1
            joint_names = _load_controllable_joints("mobile_a2_single_arm.yml")
        else:
            raise NotImplementedError("Env name is not recognized")
        self.joint_names = joint_names

        self.right_model = _ArmModel("right")
        self.right_arm_joints = np.array(
            [joint_names.index(n) for n in self.right_model.joint_names], np.uint8)
        if self.n_arms == 2:
            self.left_model = _ArmModel("left")
            self.left_arm_joints = np.array(
                [joint_names.index(n) for n in self.left_model.joint_names], np.uint8)
        else:
            self.left_model = None
            self.left_arm_joints = np.array([], np.uint8)
        self.osc_extra_joints = np.array(
            [i for i, name in enumerate(joint_names)
             if "left_panda_joint" not in name and "right_panda_joint" not in name],
            np.uint8,
        )
        self.right_arm_dim = len(self.right_arm_joints)
        self.left_arm_dim = len(self.left_arm_joints)
        self.null_space_dim = self.right_arm_dim + self.left_arm_dim
        self.osc_extra_dim = len(self.osc_extra_joints)
        self.osc_dim = self.osc_extra_dim + 6 * self.n_arms
        assert self.right_arm_dim + self.left_arm_dim + self.osc_extra_dim == len(joint_names)

    def get_J(self, qpos, mode: str = "right") -> np.ndarray:
        if mode == "right":
            return self.right_model.local_jacobian_T(np.asarray(qpos)[self.right_arm_joints])
        return self.left_model.local_jacobian_T(np.asarray(qpos)[self.left_arm_joints])

    # ----------------------------------------------------------- transforms
    def joint_space_to_operational_space_and_null_space(self, qpos, joint_space_action):
        joint_space_action = np.asarray(joint_space_action, np.float64)
        osc_extra_action = joint_space_action[self.osc_extra_joints]

        rJ = self.get_J(qpos)
        r_action = nullspace_method(rJ, joint_space_action[self.right_arm_joints])
        r_null = joint_space_action[self.right_arm_joints] - rJ @ r_action

        if self.n_arms == 2:
            lJ = self.get_J(qpos, "left")
            l_action = nullspace_method(lJ, joint_space_action[self.left_arm_joints])
            l_null = joint_space_action[self.left_arm_joints] - lJ @ l_action
            osc_action = np.concatenate([osc_extra_action, r_action, l_action])
            null_action = np.concatenate([r_null, l_null])
        else:
            osc_action = np.concatenate([osc_extra_action, r_action])
            null_action = r_null
        return osc_action, null_action

    def operational_space_and_null_space_to_joint_space(
        self, qpos, operational_space_action, null_space_action, do_projection: bool = True
    ):
        from scipy.linalg import null_space

        operational_space_action = np.asarray(operational_space_action, np.float64)
        null_space_action = np.asarray(null_space_action, np.float64)
        assert len(operational_space_action) == self.osc_dim
        assert len(null_space_action) == self.null_space_dim

        final_action = np.zeros(len(self.joint_names))
        final_action[self.osc_extra_joints] = operational_space_action[: self.osc_extra_dim]
        arms = operational_space_action[self.osc_extra_dim:]
        len_right_arm = self.right_arm_dim

        rJ = self.get_J(qpos)
        r_null = null_space_action[:len_right_arm]
        if do_projection:
            r_null_base = null_space(rJ.T)
            r_null = r_null_base @ (r_null @ r_null_base)
        final_action[self.right_arm_joints] = rJ @ arms[:6] + r_null
        if self.n_arms == 2:
            lJ = self.get_J(qpos, "left")
            l_null = null_space_action[len_right_arm:]
            if do_projection:
                l_null_base = null_space(lJ.T)
                l_null = l_null_base @ (l_null @ l_null_base)
            final_action[self.left_arm_joints] = lJ @ arms[6:] + l_null
        return final_action

    def get_robot_qpos_from_obs(self, obs):
        """Recover the controllable-joint qpos (base xy+yaw dummied to zero,
        exactly as the reference does — osc.py:162-176 appends ``zeros(3)``)
        from THIS repo's agent observation layout.

        ``A2Robot.get_obs`` (a2_robot.py:301, mirroring agent.py:369-433)
        packs ``[ee_pos(6n), ee_vel(6n), base_vel(2), base_ang_vel(1),
        qpos(1+9n), qvel(1+9n)]`` and appends ``base_pos(2) +
        base_orientation(1)`` only when not in ego mode — so the arm qpos
        block sits at a FIXED offset from the front in both modes.  State-mode
        task observations are ``concat[agent_obs, task extras]``
        (mjc_task.py:191-195) and pointcloud observations carry the agent
        block under the ``"state"`` key, so the slice is front-anchored
        (the reference slices from the END because its envs append the agent
        state last; ours lead with it)."""
        if isinstance(obs, dict):
            agent_state = obs["state"] if "state" in obs else obs["agent"]
        elif isinstance(obs, np.ndarray):
            agent_state = obs  # agent block leads the flat state obs
        else:
            raise NotImplementedError()
        s = np.asarray(agent_state, np.float64)
        off = self.n_arms * 12 + 3            # skip ee_pos/ee_vel + base vels
        qpos_arm = s[off: off + 1 + 9 * self.n_arms]
        return np.concatenate([np.zeros(3), qpos_arm])
