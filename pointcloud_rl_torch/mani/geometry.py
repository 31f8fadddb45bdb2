# Copy of pointcloud_rl_tpu/mani/geometry.py for the PyTorch port, which imports nothing of that package.
"""Pose/quaternion math and dense-reward helpers for manipulation tasks.

Parity targets: reference ``mani_skill/mani_skill/utils/contrib.py`` (reward
shaping: ``rew_close_to_target``:126, ``normalize_and_clip_in_interval``:146,
``angle_distance``:166, pose distances:189-205) and the transforms3d
quaternion calls used by ``config_parser.py`` — reimplemented numpy-only
(no transforms3d/sapien dependency).  Quaternions are wxyz, matching SAPIEN.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


# --------------------------------------------------------------- quaternions
def qmult(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    """Hamilton product of wxyz quaternions."""
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def qinverse(q: np.ndarray) -> np.ndarray:
    q = np.asarray(q, np.float64)
    conj = q * np.array([1.0, -1.0, -1.0, -1.0])
    return conj / (q @ q)


def qnorm(q) -> np.ndarray:
    q = np.asarray(q, np.float64)
    return q / np.linalg.norm(q)


def axangle2quat(axis, angle: float) -> np.ndarray:
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    half = angle / 2.0
    return np.concatenate([[np.cos(half)], axis * np.sin(half)])


def euler2quat(ax: float, ay: float, az: float) -> np.ndarray:
    """Intrinsic sxyz Euler angles -> wxyz quaternion (transforms3d default)."""
    qx = axangle2quat([1, 0, 0], ax)
    qy = axangle2quat([0, 1, 0], ay)
    qz = axangle2quat([0, 0, 1], az)
    return qmult(qz, qmult(qy, qx))


def mat2quat(R) -> np.ndarray:
    """Rotation matrix -> wxyz quaternion (Shepperd's method)."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] >= R[1, 1] and R[0, 0] >= R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] >= R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return qnorm([w, x, y, z])


def quat2mat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = qnorm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def qrotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vector(s) ``v`` ([..., 3]) by quaternion ``q``."""
    return np.asarray(v) @ quat2mat(q).T


def rotate_2d_vec_by_angle(vec, angle: float) -> np.ndarray:
    """Rotate an [x, y] vector by ``angle`` radians (mobile-base ego frame,
    reference mani_skill/utils/geometry.py)."""
    c, s = np.cos(angle), np.sin(angle)
    x, y = vec
    return np.array([c * x - s * y, s * x + c * y])


class Pose:
    """Rigid transform (p [3], q wxyz [4]) with SAPIEN-Pose-like surface."""

    __slots__ = ("p", "q")

    def __init__(self, p=(0.0, 0.0, 0.0), q=(1.0, 0.0, 0.0, 0.0)):
        self.p = np.asarray(p, np.float64)
        self.q = qnorm(q)

    def inv(self) -> "Pose":
        qi = qinverse(self.q)
        return Pose(-qrotate(qi, self.p), qi)

    def transform(self, other: "Pose") -> "Pose":
        return Pose(self.p + qrotate(self.q, other.p), qmult(self.q, other.q))

    def __mul__(self, other: "Pose") -> "Pose":
        return self.transform(other)

    def to_transformation_matrix(self) -> np.ndarray:
        m = np.eye(4)
        m[:3, :3] = quat2mat(self.q)
        m[:3, 3] = self.p
        return m

    @classmethod
    def from_transformation_matrix(cls, m) -> "Pose":
        m = np.asarray(m, np.float64)
        return cls(m[:3, 3], mat2quat(m[:3, :3]))

    def __repr__(self):
        return f"Pose(p={self.p.tolist()}, q={self.q.tolist()})"


def apply_pose_to_points(x: np.ndarray, pose: Pose) -> np.ndarray:
    """Transform [N, 3] points by a pose (contrib.py:76)."""
    return qrotate(pose.q, np.asarray(x)) + pose.p


# ------------------------------------------------------------ reward helpers
def norm(x, keepdims: bool = False):
    x = np.asarray(x)
    return np.sqrt((x ** 2).sum(axis=-1, keepdims=keepdims))


def normalize_vec(x):
    x = np.asarray(x, np.float64)
    n = np.linalg.norm(x)
    return x / n if n > 0 else x


def clip(x, min_x, max_x):
    return min(max(min_x, x), max_x)


def normalize_and_clip_in_interval(x, min_x, max_x=None):
    """Map x into [0, 1] over [min_x, max_x]; one-arg form uses [-|a|, |a|]
    (contrib.py:146 — including its quirk that the one-arg interval is
    symmetric)."""
    if max_x is None:
        min_x = -abs(min_x)
        max_x = abs(min_x)
    return (clip(x, min_x, max_x) - min_x) / (max_x - min_x)


def angle_between_vec(a, b) -> float:
    return float(np.arccos(np.clip(np.dot(a, b), -1.0, 1.0)) / np.pi)


def rew_close_to_target(pos, vel, target_pos, max_dist=1, max_vel=1,
                        dist_coeff=1, vel_coeff=2, angle_coeff=1) -> Tuple[float, dict]:
    """Staged approach reward (contrib.py:126): distance shaping + velocity
    projected onto the target direction + velocity-direction alignment."""
    ret = 0.0
    info = {}
    target_vel = normalize_vec(np.asarray(target_pos) - np.asarray(pos))
    info["target_vel"] = target_vel
    if dist_coeff > 0:
        dist = norm(np.asarray(pos) - np.asarray(target_pos))
        info["rew_dist"] = (1 - normalize_and_clip_in_interval(dist, 0, max_dist)) * dist_coeff
        ret += info["rew_dist"]
    if vel_coeff > 0:
        vel_norm = float(np.dot(vel, target_vel))
        info["rew_vel"] = normalize_and_clip_in_interval(vel_norm, max_vel) * vel_coeff
        ret += info["rew_vel"]
    if angle_coeff > 0:
        vel_angle = angle_between_vec(normalize_vec(vel), target_vel)
        info["rew_vel_angle"] = (1 - vel_angle) * angle_coeff
        ret += info["rew_vel_angle"]
    return ret, info


def angle_distance(q0, q1) -> float:
    """Rotation angle between two quaternions, /pi-normalized
    (reference utils/geometry.py:62-64, used by BaseEnv's actor-static
    check): ``2*arctan2(||v||, w)/pi`` of the relative quaternion — NOT
    canonicalized, so a negative-w relative rotation exceeds 1.0 exactly
    as the reference's does."""
    qd = qmult(qinverse(np.asarray(q0, np.float64)), np.asarray(q1, np.float64))
    theta = 2 * np.arctan2(float(np.linalg.norm(qd[1:])), float(qd[0]))
    return float(theta / np.pi)


def quaternion_distance(q1, q2) -> float:
    """``1 - |w|`` of the relative quaternion (contrib.py:175-179)."""
    qd = qmult(qinverse(np.asarray(q1, np.float64)), np.asarray(q2, np.float64))
    return float(1.0 - abs(qd[0]))


def pose_vec_distance(pose1: Pose, pose2: Pose) -> float:
    """``dist_p + 0.01 * quaternion_distance`` (contrib.py:189-192)."""
    return float(norm(pose1.p - pose2.p)) + 0.01 * quaternion_distance(pose1.q, pose2.q)
