"""The port's models against the JAX package's, on parameters converted
by ``pointcloud_rl_torch.convert.params_from_jax`` and inputs made with numpy.

Also home of the small helpers the other ``test_torch_*`` files share:
the SAC + PointNet slice config (``pn_fake_manipulation.py``) cut to a
tiny size, and its observations.
"""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_rl_torch.convert import _to_torch_name, flax_path, params_from_jax
from pointcloud_rl_tpu.config import Config

torch.set_num_threads(1)

_REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
SLICE_CONFIG = osp.join(_REPO, "configs/mfrl/sac/synthetic/pn_fake_manipulation.py")
# The DrQ slice: the same networks and env, DrQ with num_aug=2 and a jitter.
DRQ_CONFIG = osp.join(_REPO, "configs/mfrl/drq/synthetic/pn_jitter_fake_manipulation.py")
# The slice config at test size: 64 points, PointNet [16,16,32] -> 16,
# heads 32 wide, batch 16.
TINY = {
    "env_cfg.n_points": 64,
    "agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.mlp_spec": [16, 16, 32],
    "agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.out_channels": 16,
    "agent_cfg.actor_cfg.nn_cfg.mlp_cfg.mlp_spec": ["16 + agent_shape", 32, 32, "action_shape * 2"],
    "agent_cfg.critic_cfg.nn_cfg.mlp_cfg.mlp_spec": ["16 + agent_shape + action_shape", 32, 32, 1],
    "agent_cfg.batch_size": 16,
}
TINY_CLI = [f"{k}={v}" for k, v in TINY.items()]
# Forward outputs of f32 models: sums in another order, ~1e-6 relative
# per layer over a handful of layers.
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
# Tanh-normal log-probs: where tanh saturates, 1 - tanh(z)^2 keeps few
# significant bits and the two frameworks' tanh differ in the last one.
LOGP_TOL = dict(rtol=1e-3, atol=1e-4)


def slice_setup(fused=True, config=SLICE_CONFIG, **agent_overrides):
    """(resolved agent_cfg dict, env_info, env_cfg) of the tiny slice
    (``config``: the SAC slice's, or ``DRQ_CONFIG``)."""
    from pointcloud_rl_torch.env import get_env_info
    from pointcloud_rl_torch.models import get_kwargs_from_shape, replace_placeholder_with_args

    cfg = Config.fromfile(config)
    cfg.merge_from_dict(dict(TINY, **{"agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.fused": fused}))
    env_cfg = dict(cfg["env_cfg"])
    env_info = get_env_info(env_cfg)
    kwargs = get_kwargs_from_shape(env_info["obs_shape"], env_info["action_shape"])
    agent_cfg = dict(replace_placeholder_with_args(dict(cfg["agent_cfg"]), **kwargs))
    agent_cfg.update(agent_overrides)
    return agent_cfg, env_info, env_cfg


def slice_obs(seed, batch, n_points=64):
    """A batch of fake-manipulation-shaped observations (rgb uint8)."""
    rs = np.random.RandomState(seed)
    return {
        "xyz": rs.randn(batch, 3, n_points).astype(np.float32),
        "rgb": rs.randint(0, 256, (batch, 3, n_points)).astype(np.uint8),
        "seg": (rs.rand(batch, 2, n_points) < 0.3).astype(np.float32),
        "state": rs.randn(batch, 32).astype(np.float32),
    }


def jax_leaf(tree, name):
    """The JAX value of the port's parameter ``name``, in the port's layout."""
    node = tree
    for key in flax_path(name):
        node = node[key]
    return _to_torch_name(flax_path(name), np.asarray(node))[1]


def _split_cfg(agent_cfg):
    actor_cfg, critic_cfg = dict(agent_cfg["actor_cfg"]), dict(agent_cfg["critic_cfg"])
    actor_cfg.pop("optim_cfg", None)
    critic_cfg.pop("optim_cfg", None)
    return actor_cfg, critic_cfg


def _build_pair(fused):
    """The JAX and the port's ActorCriticModel of the tiny slice, same params."""
    from pointcloud_rl_torch.models import build_actor_critic as t_build
    from pointcloud_rl_torch.algorithms.base import example_obs_from_shape
    from pointcloud_rl_tpu.models import build_actor_critic as j_build

    agent_cfg, env_info, _ = slice_setup(fused=fused)
    actor_cfg, critic_cfg = _split_cfg(agent_cfg)
    j_model = j_build(actor_cfg, critic_cfg, env_info, shared_backbone=True)
    params = j_model.init_params(jax.random.PRNGKey(0), example_obs_from_shape(env_info["obs_shape"]),
                                 np.zeros((1, 8), np.float32))
    t_model = t_build(actor_cfg, critic_cfg, env_info, shared_backbone=True,
                      generator=torch.Generator().manual_seed(0))
    t_model.load_state_dict(params_from_jax(params))
    return j_model, params, t_model


def _t(obs):
    return {k: torch.from_numpy(v) for k, v in obs.items()}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_pointnet_matches_jax(fused):
    """One canonical parameter set: the port's PointNet, fused or not,
    against the JAX PointNet on an {xyz, rgb uint8, seg} cloud."""
    from pointcloud_rl_torch.models import build_all as t_build_all
    from pointcloud_rl_tpu.models import build_all as j_build_all

    cfg = dict(type="PointNet", feat_dim=8, mlp_spec=[16, 32, 64], out_channels=20,
               feature_transform=[], ignore_first_ln=True, fused=fused)
    obs = slice_obs(0, 3, n_points=100)
    obs.pop("state")
    j_pn = j_build_all(dict(cfg, fused=False))
    jparams = j_pn.init({"params": jax.random.PRNGKey(0)}, obs)["params"]
    want = np.asarray(j_pn.apply({"params": jparams}, obs))
    t_pn = t_build_all(cfg)
    assert t_pn._fused_supported() == fused
    t_pn.load_state_dict(params_from_jax(jparams))
    got = t_pn(_t(obs))
    assert tuple(got.shape) == (3, 20)
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD_TOL)


def test_state_dict_names_are_flax_paths():
    """Every port parameter has a JAX counterpart of the same shape, and
    the two trees hold the same number of leaves."""
    _, params, t_model = _build_pair(fused=True)
    sd = t_model.state_dict()
    assert len(sd) == len(jax.tree_util.tree_leaves(params))
    for name, value in sd.items():
        assert jax_leaf(params, name).shape == tuple(value.shape), name


def test_tanh_gaussian_head_matches_jax_with_injected_noise(monkeypatch):
    from pointcloud_rl_torch.models import heads as t_heads
    from pointcloud_rl_torch.models.heads import TanhGaussianHead as THead
    from pointcloud_rl_tpu.models import distributions as jd
    from pointcloud_rl_tpu.models import heads as j_heads

    rs = np.random.RandomState(1)
    feature = rs.randn(6, 8).astype(np.float32)
    eps = rs.randn(6, 4).astype(np.float32)
    bound = [-np.ones(4, np.float32), 2 * np.ones(4, np.float32)]

    def j_sample(key, mean, std, scale, bias, epsilon=1e-6):
        z = mean + std * jnp.asarray(eps)
        return jd.tanh_transform(z, scale, bias), jd.tanh_log_prob_with_logit(z, mean, std, scale, epsilon)

    def t_sample(generator, mean, std, scale, bias, epsilon=1e-6):
        from pointcloud_rl_torch.models import distributions as td

        z = mean + std * torch.from_numpy(eps)
        return td.tanh_transform(z, scale, bias), td.tanh_log_prob_with_logit(z, mean, std, scale, epsilon)

    monkeypatch.setattr(j_heads, "tanh_normal_rsample_with_log_prob", j_sample)
    monkeypatch.setattr(t_heads, "tanh_normal_rsample_with_log_prob", t_sample)
    j_head = j_heads.TanhGaussianHead(dim_output=4, bound=bound, log_std_bound=(-10, 2))
    t_head = THead(dim_output=4, bound=bound, log_std_bound=(-10, 2))
    rngs = {"sample": jax.random.PRNGKey(0)}
    for mode in ("eval", "max-entropy"):
        want = j_head.apply({}, jnp.asarray(feature), mode=mode, rngs=rngs)
        got = t_head(torch.from_numpy(feature), mode=mode)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            tol = LOGP_TOL if (mode == "max-entropy" and i == 1) else FWD_TOL
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol, err_msg=mode)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_actor_and_critic_apply_match_jax(fused):
    """actor_apply(mode="eval") and critic_apply on the fake-manipulation
    obs structure, robot state included."""
    j_model, params, t_model = _build_pair(fused)
    obs = slice_obs(2, 5)
    actions = np.clip(np.random.RandomState(3).randn(5, 8), -1, 1).astype(np.float32)
    j_act, j_feat = j_model.actor_apply(params, obs, mode="eval")
    j_q = j_model.critic_apply(params, obs, actions=jnp.asarray(actions))
    with torch.no_grad():
        t_act, t_feat = t_model.actor_apply(_t(obs), mode="eval")
        t_q = t_model.critic_apply(_t(obs), actions=torch.from_numpy(actions))
    assert tuple(t_q.shape) == (5, 2)
    np.testing.assert_allclose(t_feat.numpy(), np.asarray(j_feat), **FWD_TOL)
    np.testing.assert_allclose(t_act.numpy(), np.asarray(j_act), **FWD_TOL)
    np.testing.assert_allclose(t_q.numpy(), np.asarray(j_q), **FWD_TOL)


def test_target_holds_only_the_critic_under_a_shared_backbone():
    _, params, t_model = _build_pair(fused=True)
    target = t_model.make_target()
    assert set(target.keys()) == {"critic"}
    assert not any(p.requires_grad for p in target.parameters())
