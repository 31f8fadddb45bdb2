"""Host-side environments, vec envs, replay, rollout and evaluation.

Numpy-only copies of the ``pointcloud_rl_tpu.env`` modules the SAC +
PointNet slice runs (each file names its source): that package's
``__init__`` imports its JAX device replay, so the port cannot import it.
Nothing here imports torch, so env worker processes stay light.
"""

from .api import Env, ExtendedEnv, FrameStackWrapper, TimeLimit, Wrapper, true_done
from .builder import (
    ENVS,
    EVALUATIONS,
    REPLAYS,
    ROLLOUTS,
    SAMPLING,
    WRAPPERS,
    build_env,
    build_evaluation,
    build_replay,
    build_rollout,
    build_vec_env,
    get_env_info,
)
from .dist_env import DistEnv
from .evaluation import Evaluation, save_eval_statistics
from .replay import ReplayMemory
from .rollout import Rollout
from .sampling_strategy import OneStepTransition, TStepTransition
from .spaces import Box, Discrete
from .vec_env import SingleEnv2VecEnv, UnifiedVectorEnvAPI, VectorEnv

__all__ = [
    "Env", "Wrapper", "ExtendedEnv", "TimeLimit", "FrameStackWrapper", "true_done",
    "ENVS", "ROLLOUTS", "EVALUATIONS", "REPLAYS", "SAMPLING", "WRAPPERS",
    "build_env", "build_vec_env", "build_rollout", "build_evaluation", "build_replay", "get_env_info",
    "DistEnv", "Evaluation", "save_eval_statistics", "ReplayMemory", "Rollout",
    "OneStepTransition", "TStepTransition", "Box", "Discrete",
    "SingleEnv2VecEnv", "UnifiedVectorEnvAPI", "VectorEnv",
]
