# Copy of pointcloud_rl_tpu/env/builder.py for the PyTorch port (that package's env imports JAX).
"""Env construction and registries.

Parity target: reference ``pyrl/env/{builder,env_utils}.py`` — registries for
envs/rollouts/evaluations/replays/sampling/wrappers, ``build_env`` assembling
the wrapper chain (domain env -> extra wrappers -> FrameStack -> TimeLimit ->
ExtendedEnv), ``get_env_info`` probing obs/action shapes for config
placeholder resolution, and vec-env assembly.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, List, Optional

import numpy as np

from ..registry import Registry, build_from_cfg
from ..utils.tree_ops import tree_shape
from .api import Env, ExtendedEnv, FrameStackWrapper, TimeLimit
from .spaces import Box, Discrete
from .vec_env import UnifiedVectorEnvAPI, build_vec_env_from_cfgs

ENVS = Registry("env")
ROLLOUTS = Registry("rollout")
EVALUATIONS = Registry("evaluation")
REPLAYS = Registry("replay")
SAMPLING = Registry("sampling")
WRAPPERS = Registry("wrapper")


def _build_base_env(env_name: str, obs_mode: str, **kwargs) -> Env:
    """Dispatch on env_name to the owning integration."""
    if env_name.startswith(("dmc_", "distract_dmc_")):
        from .dmc import build_dmc_env

        return build_dmc_env(env_name, obs_mode=obs_mode, **kwargs)
    if env_name.startswith("reacher3d_easy"):
        from .dist_env import DistEnv

        return DistEnv(obs_mode=obs_mode, **kwargs)
    if env_name.startswith("FakeManipulation"):
        from .fake_manipulation import FakeManipulationEnv

        return FakeManipulationEnv(obs_mode=obs_mode, **kwargs)
    if env_name.startswith("MoveBucketMJC"):
        # Real-physics MoveBucket on MuJoCo with the PartNet-Mobility assets
        # (no SAPIEN needed): MoveBucketMJC_{train,val}-v0
        from .mujoco_manipulation import MoveBucketEnv

        split = env_name.split("_", 1)[1].split("-")[0] if "_" in env_name else "train"
        return MoveBucketEnv(split=split, obs_mode=obs_mode, **kwargs)
    if env_name.startswith(("OpenCabinetDoorMJC", "OpenCabinetDrawerMJC")):
        # Procedural-cabinet ports of the OpenCabinet tasks on MuJoCo
        # (no SAPIEN/PartNet cabinets needed):
        # OpenCabinet{Door,Drawer}MJC_{train,val}-v0
        from .cabinet_tasks import OpenCabinetDoorEnv, OpenCabinetDrawerEnv

        cls = OpenCabinetDoorEnv if "Door" in env_name else OpenCabinetDrawerEnv
        split = env_name.split("_", 1)[1].split("-")[0] if "_" in env_name else "train"
        return cls(split=split, obs_mode=obs_mode, **kwargs)
    if env_name.startswith("PushChairMJC"):
        from .chair_task import PushChairEnv

        split = env_name.split("_", 1)[1].split("-")[0] if "_" in env_name else "train"
        return PushChairEnv(split=split, obs_mode=obs_mode, **kwargs)
    if any(env_name.startswith(p) for p in ("OpenCabinetDoor", "OpenCabinetDrawer", "PushChair", "MoveBucket")):
        from .maniskill import build_maniskill_env

        return build_maniskill_env(env_name, obs_mode=obs_mode, **kwargs)
    # Fallback: gymnasium registry.
    try:
        import gymnasium

        from .gym_adapter import GymnasiumAdapter

        return GymnasiumAdapter(gymnasium.make(env_name, **kwargs))
    except Exception as e:
        raise KeyError(f"Unknown env {env_name}: {e}") from e


@ENVS.register_module(name="gym")
def make_gym_env(
    env_name: str,
    obs_mode: str = "state",
    stack_frame: int = 1,
    reward_scale: float = 1.0,
    use_cost: bool = False,
    horizon: Optional[int] = None,
    extra_wrappers=None,
    **kwargs,
) -> Env:
    """Assemble the standard wrapper chain (reference env_utils.py:116-203)."""
    env = _build_base_env(env_name, obs_mode, **kwargs)
    if extra_wrappers is not None:
        if not isinstance(extra_wrappers, (list, tuple)):
            extra_wrappers = [extra_wrappers]
        for wcfg in extra_wrappers:
            env = build_from_cfg(dict(wcfg), WRAPPERS, dict(env=env))
    if stack_frame > 1:
        env = FrameStackWrapper(env, stack_frame)
    if horizon is not None:
        env = TimeLimit(env, horizon)
    env = ExtendedEnv(env, reward_scale=reward_scale, use_cost=use_cost)
    env.obs_mode = obs_mode
    env.env_name = env_name
    return env


def _register_wrappers() -> None:
    """Populate the WRAPPERS registry (idempotent; avoids import cycles)."""
    if "FrameStackWrapper" in WRAPPERS:
        return
    from .api import ExtendedEnv, FixedInitWrapper, FrameStackWrapper, MuJoCoVisualWrapper, TimeLimit

    WRAPPERS.register_module(module=FrameStackWrapper)
    WRAPPERS.register_module(module=FixedInitWrapper)
    WRAPPERS.register_module(module=TimeLimit)
    WRAPPERS.register_module(module=ExtendedEnv)
    WRAPPERS.register_module(module=MuJoCoVisualWrapper)
    WRAPPERS.register_module(name="MuJoCoVisual", module=MuJoCoVisualWrapper)


def build_env(env_cfg: dict) -> Env:
    _register_wrappers()
    cfg = dict(env_cfg)
    # server_obs selects the vec-env-level device fusion path
    # (env/server_env.py); a standalone env always uses the host pipeline,
    # which produces the identical observation contract.
    cfg.pop("server_obs", None)
    cfg.setdefault("type", "gym")
    return build_from_cfg(cfg, ENVS)


def get_env_info(env_cfg: dict, env: Optional[Env] = None) -> Dict[str, Any]:
    """Probe obs/action shapes (reference env_utils.py:86-103)."""
    close_env = env is None
    if env is None:
        env = build_env(env_cfg)
    try:
        obs = env.reset()
        obs_shape = tree_shape(obs)
        space = env.action_space
        if isinstance(space, Discrete):
            is_discrete, action_shape = True, space.n
        else:
            is_discrete, action_shape = False, int(np.prod(space.shape))
        return dict(
            obs_shape=obs_shape,
            action_shape=action_shape,
            action_space=space,
            is_discrete=is_discrete,
        )
    finally:
        if close_env:
            env.close()


def build_vec_env(env_cfg: dict, num_procs: int = 1, base_seed: Optional[int] = None,
                  vec_backend: Optional[str] = None, device="cuda", **override) -> UnifiedVectorEnvAPI:
    """``num_procs`` copies of ``env_cfg`` as one vec env; ``device`` is
    where a ``server_obs`` env fuses its observations."""
    cfgs = []
    for i in range(num_procs):
        cfg = deepcopy(dict(env_cfg))
        cfg.update(override)
        cfgs.append(cfg)
    seeds = None if base_seed is None else [base_seed + i for i in range(num_procs)]
    return build_vec_env_from_cfgs(cfgs, seeds=seeds, use_subprocess=num_procs > 1,
                                   backend=vec_backend, device=device)


def build_rollout(cfg, default_args=None):
    return build_from_cfg(cfg, ROLLOUTS, default_args) if cfg is not None else None


def build_evaluation(cfg, default_args=None):
    return build_from_cfg(cfg, EVALUATIONS, default_args) if cfg is not None else None


def build_replay(cfg, default_args=None, device=None):
    """The replay ``cfg`` asks for; a ``DeviceReplayMemory`` keeps its
    storage on ``device`` (when given), a host replay ignores it."""
    if cfg is None:
        return None
    if cfg.get("type") == "DeviceReplayMemory":
        from . import device_replay  # noqa: F401  (registers it; the one env module that imports torch)

        if device is not None:
            default_args = dict(default_args or {}, device=device)
    return build_from_cfg(cfg, REPLAYS, default_args)


def build_sampling(cfg, default_args=None):
    return build_from_cfg(cfg, SAMPLING, default_args) if cfg is not None else None
