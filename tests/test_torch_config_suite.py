"""Every shipped config in the port: the counterpart of ``tests/test_config_suite.py``.

Each config under ``configs/mfrl`` loads through the port's ``Config``,
resolves its placeholders against the fake env info of that test, and
builds its agent in the port at the config's full widths on the CPU.  For
the ManiSkill configs the port's parameters have the names and shapes of
the JAX package's after ``convert`` (the JAX shapes come from
``jax.eval_shape`` of the model's init, which compiles nothing).  A
ManiSkill env without ``sapien`` raises the same ``ImportError`` as the JAX
package, and a MuJoCo manipulation env (``*MJC*``) without the A2 robot or
PartNet-Mobility assets raises the JAX package's own error.
"""

import glob
import os.path as osp
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, osp.dirname(__file__))

from test_config_suite import _fake_env_info  # noqa: E402

from pointcloud_rl_torch.config import Config  # noqa: E402
from pointcloud_rl_torch.convert import _flatten, _to_torch_name  # noqa: E402

torch.set_num_threads(1)

_REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIGS = sorted(osp.relpath(p, _REPO) for p in glob.glob(osp.join(_REPO, "configs/mfrl/**/*.py"), recursive=True))
MANISKILL = ("OpenCabinetDoor", "OpenCabinetDrawer", "PushChair", "MoveBucket")


def _setup(path):
    from pointcloud_rl_torch.models import get_kwargs_from_shape, replace_placeholder_with_args

    cfg = Config.fromfile(osp.join(_REPO, path))
    env_cfg = dict(cfg["env_cfg"])
    env_info = _fake_env_info(env_cfg)
    kwargs = get_kwargs_from_shape(env_info["obs_shape"], env_info["action_shape"])
    agent_cfg = replace_placeholder_with_args(dict(cfg["agent_cfg"]), **kwargs)
    return dict(agent_cfg), env_info, env_cfg


def _is_maniskill(name):
    return name.startswith(MANISKILL) and "MJC" not in name


def _jax_param_shapes(agent_cfg, env_info):
    """{port parameter name: shape} of the JAX model, through ``convert``'s naming."""
    from pointcloud_rl_tpu.algorithms.base import example_obs_from_shape
    from pointcloud_rl_tpu.models import build_actor_critic

    actor_cfg, critic_cfg = dict(agent_cfg["actor_cfg"]), dict(agent_cfg["critic_cfg"])
    actor_cfg.pop("optim_cfg", None)
    critic_cfg.pop("optim_cfg", None)
    model = build_actor_critic(actor_cfg, critic_cfg, env_info,
                               shared_backbone=agent_cfg.get("shared_backbone", False))
    obs = example_obs_from_shape(env_info["obs_shape"])
    action = np.zeros((1, env_info["action_shape"]), np.float32)
    shapes = jax.eval_shape(lambda: model.init_params(jax.random.PRNGKey(0), obs, action))
    out = {}
    for path, leaf in _flatten(jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                                                      shapes)).items():
        name, value = _to_torch_name(path, leaf)
        out[name] = tuple(value.shape)
    return out


@pytest.mark.parametrize("path", CONFIGS, ids=[p.split("configs/")[1] for p in CONFIGS])
def test_config_builds_its_agent_in_the_port(path):
    from pointcloud_rl_torch.algorithms import build_agent
    from pointcloud_rl_torch.env.builder import _build_base_env

    agent_cfg, env_info, env_cfg = _setup(path)
    assert agent_cfg["type"] in ("SAC", "DrQ")
    agent = build_agent(dict(agent_cfg, env_params=env_info, seed=0, device="cpu"))
    assert type(agent).__name__ == agent_cfg["type"] and agent.num_params > 0
    model = agent.model
    assert model.actor is not None and model.critic is not None
    if env_cfg.get("obs_mode") == "pointcloud":
        assert model.visual is not None
    if agent_cfg["type"] == "DrQ" and agent_cfg.get("obs_aug") is not None:
        assert agent.obs_aug is not None

    name = env_cfg["env_name"]
    if _is_maniskill(name):
        # the port's parameters are the JAX package's, name for name and shape for shape
        got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert got == _jax_param_shapes(agent_cfg, env_info)
        if "sapien" not in sys.modules:
            with pytest.raises(ImportError, match="sapien"):
                _build_base_env(name, env_cfg.get("obs_mode", "state"))
    if "MJC" in name:
        from pointcloud_rl_torch.env import a2_robot, mujoco_manipulation
        from pointcloud_rl_tpu.env.builder import _build_base_env as jax_build_base_env

        if not (a2_robot.robot_assets_available() or mujoco_manipulation.assets_available()):
            errors = []
            for build in (_build_base_env, jax_build_base_env):
                with pytest.raises(AssertionError) as info:
                    build(name, env_cfg.get("obs_mode", "state"))
                errors.append(str(info.value))
            assert errors[0] == errors[1], errors
            assert "A2 robot" in errors[0] or "PartNet-Mobility" in errors[0], errors


def test_the_suite_holds_every_config():
    assert len(CONFIGS) >= 43
    assert sum(_is_maniskill(dict(Config.fromfile(osp.join(_REPO, p))["env_cfg"])["env_name"]) for p in CONFIGS) >= 13
