# Copy of pointcloud_rl_tpu/mani/__init__.py for the PyTorch port, which imports nothing of that package.
"""ManiSkill benchmark framework pieces that do not require the SAPIEN
simulator (reference ``mani_skill/mani_skill/``): joint controllers, the YAML
task-config pipeline, geometry/reward helpers, and the challenge-style
evaluation harness.

The physics/render layer (SAPIEN, C++/Vulkan) stays host-side and external;
these modules are the pure-Python machinery around it, rebuilt so the task
specs, controller stacks, and evaluation protocol work in this framework —
against SAPIEN when it is installed, and against the synthetic
``FakeManipulationEnv`` otherwise.
"""

from .config_parser import load_task_config, process_variables, process_variants
from .controllers import (
    LPFilter,
    PIDController,
    PositionController,
    VelocityController,
    build_joint_controllers,
)
from .evaluator import BasePolicy, Evaluator
from .geometry import (
    Pose,
    angle_distance,
    apply_pose_to_points,
    axangle2quat,
    euler2quat,
    normalize_and_clip_in_interval,
    pose_vec_distance,
    qinverse,
    qmult,
    qrotate,
    quaternion_distance,
    rew_close_to_target,
)

__all__ = [
    "load_task_config", "process_variables", "process_variants",
    "LPFilter", "PIDController", "PositionController", "VelocityController",
    "build_joint_controllers",
    "BasePolicy", "Evaluator",
    "Pose", "qmult", "qinverse", "qrotate", "euler2quat", "axangle2quat",
    "apply_pose_to_points", "angle_distance", "quaternion_distance",
    "pose_vec_distance",
    "normalize_and_clip_in_interval", "rew_close_to_target",
]
