"""The port's SAC variants, optimizers and schedulers against the JAX
package's: discrete SAC, ``obs_rms`` on flat states, the critic's
``share_feature`` with ``average_grad``, every branch of
``make_optimizer`` over several steps, and the schedulers.

Agents load the JAX agent's parameters through ``params_from_jax``; a
fixed batch feeds both; the Gaussian draws are injected as in
``tests/test_torch_recurrent.py``.
"""

import os.path as osp
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, osp.dirname(__file__))

from test_torch_recurrent import assert_params_track, pin_normal_by_shape  # noqa: E402
from test_torch_sac import _batch, _FixedMemory  # noqa: E402
from test_torch_models import slice_setup  # noqa: E402

from pointcloud_rl_torch.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)

N_UPDATES = 4
METRIC_RTOL = 1e-3  # f32 sums in another order, through 4 updates


class _Box:
    def __init__(self, dim):
        self.low, self.high = -np.ones(dim, np.float32), np.ones(dim, np.float32)
        self.shape = (dim,)

    def is_bounded(self):
        return True


def _pair(cfg):
    from pointcloud_rl_torch.algorithms import build_agent as t_build_agent
    from pointcloud_rl_tpu.algorithms import build_agent as j_build_agent

    j_agent = j_build_agent(dict(cfg, seed=0))
    t_agent = t_build_agent(dict(cfg, seed=0, device="cpu"))
    st = j_agent.train_state
    t_agent.load_params(params_from_jax(st.params, st.target_params, st.log_alpha))
    return j_agent, t_agent


def _compare_updates(j_agent, t_agent, memory_fn, prefix="sac", keys=("critic_loss", "q", "q_target", "alpha",
                                                                     "critic_grad", "actor_loss", "entropy",
                                                                     "actor_grad", "alpha_loss")):
    for u in range(N_UPDATES):
        j_m = j_agent.update_parameters(memory_fn(), updates=u)
        t_m = t_agent.update_parameters(memory_fn(), updates=u)
        assert sorted(t_m) == sorted(j_m), (sorted(t_m), sorted(j_m))
        for key in keys:
            if f"{prefix}/{key}" in j_m:
                a, b = j_m[f"{prefix}/{key}"], t_m[f"{prefix}/{key}"]
                assert abs(a - b) < METRIC_RTOL * (1 + abs(a)), f"update {u} {key}: jax {a} vs torch {b}"
    return j_m, t_m


# ---------------------------------------------------------------- discrete
def _discrete_cfg(obs_dim=6, n=4):
    return dict(
        type="SAC", batch_size=16,
        env_params=dict(is_discrete=True, obs_shape=obs_dim, action_shape=n, action_space=None),
        actor_cfg=dict(type="DiscreteActor", head_cfg=dict(type="DiscreteBaseHead"),
                       nn_cfg=dict(type="LinearMLP", norm_cfg=None, mlp_spec=[obs_dim, 32, n], inactivated_output=True),
                       optim_cfg=dict(type="Adam", lr=1e-3)),
        critic_cfg=dict(type="DiscreteCritic", num_heads=2,
                        nn_cfg=dict(type="LinearMLP", norm_cfg=None, mlp_spec=[obs_dim, 32, n], inactivated_output=True),
                        optim_cfg=dict(type="Adam", lr=1e-3)),
    )


def _flat_batch(obs_dim, actions, seed=0, n=16):
    rs = np.random.RandomState(seed)
    return dict(obs=(rs.randn(n, obs_dim) * 3 + 1).astype(np.float32),
                next_obs=(rs.randn(n, obs_dim) * 3 + 1).astype(np.float32), actions=actions(rs, n),
                rewards=rs.randn(n, 1).astype(np.float32), dones=rs.rand(n, 1) < 0.2,
                episode_dones=np.zeros((n, 1), bool))


def test_discrete_sac_updates_match_jax():
    """V = sum pi*Q targets, the categorical actor loss, the label-smoothed
    target entropy and alpha's log(0.1) start, q_match_rate."""
    j_agent, t_agent = _pair(_discrete_cfg())
    assert t_agent.target_entropy == pytest.approx(j_agent.target_entropy, rel=1e-12)
    assert float(t_agent.log_alpha.detach()) == pytest.approx(float(j_agent.train_state.log_alpha), abs=1e-7)
    batch = _flat_batch(6, lambda rs, n: rs.randint(0, 4, (n, 1)))
    _, t_m = _compare_updates(j_agent, t_agent, lambda: _FixedMemory(batch), keys=(
        "critic_loss", "q", "q_target", "alpha", "critic_grad", "actor_loss", "entropy", "actor_grad",
        "alpha_loss", "q_match_rate"))
    assert "sac/q_match_rate" in t_m
    assert_params_track(j_agent, t_agent, N_UPDATES, 1e-3)
    obs = batch["obs"][:5]
    greedy = t_agent.forward(obs, mode="eval")
    assert greedy.shape == (5, 1) and greedy.dtype == np.int64
    np.testing.assert_array_equal(greedy, np.asarray(j_agent.forward(obs, mode="eval")))
    assert t_agent.forward(obs, mode="explore").shape == (5, 1)


# ------------------------------------------------------------------ obs_rms
def test_obs_rms_normalises_the_update_batches_like_jax(monkeypatch):
    obs_dim, act_dim = 5, 2
    cfg = dict(
        type="SAC", batch_size=16, gamma=0.9, obs_rms=True, actor_update_interval=1, target_update_interval=1,
        env_params=dict(is_discrete=False, obs_shape=obs_dim, action_shape=act_dim, action_space=_Box(act_dim)),
        actor_cfg=dict(type="ContinuousActor", head_cfg=dict(type="TanhGaussianHead", log_std_bound=[-10, 2]),
                       nn_cfg=dict(type="LinearMLP", norm_cfg=None, mlp_spec=[obs_dim, 32, 2 * act_dim],
                                   inactivated_output=True),
                       optim_cfg=dict(type="Adam", lr=1e-3)),
        critic_cfg=dict(type="ContinuousCritic", num_heads=2,
                        nn_cfg=dict(type="LinearMLP", norm_cfg=None, mlp_spec=[obs_dim + act_dim, 32, 1],
                                    inactivated_output=True),
                        optim_cfg=dict(type="Adam", lr=1e-3)),
    )
    j_agent, t_agent = _pair(cfg)
    pin_normal_by_shape(monkeypatch)
    batches = [_flat_batch(obs_dim, lambda rs, n: rs.uniform(-0.9, 0.9, (n, act_dim)).astype(np.float32), seed=s)
               for s in range(N_UPDATES)]
    it = iter([b for b in batches for _ in (0, 1)])  # each batch once per agent
    _compare_updates(j_agent, t_agent, lambda: _FixedMemory(next(it)))
    np.testing.assert_allclose(t_agent.obs_rms.mean, j_agent.obs_rms.mean, rtol=1e-12)
    np.testing.assert_allclose(t_agent.obs_rms.var, j_agent.obs_rms.var, rtol=1e-12)
    assert t_agent.obs_rms.count == j_agent.obs_rms.count == 16 * N_UPDATES
    assert_params_track(j_agent, t_agent, N_UPDATES, 1e-3)


# ------------------------------------------------------------ share_feature
def test_share_feature_updates_match_jax(monkeypatch):
    """The critic input's gradient scaled by 1/num_q (``average_grad``) on
    the point-cloud slice, where it reaches the shared PointNet."""
    from pointcloud_rl_torch.algorithms import build_agent as t_build_agent
    from pointcloud_rl_tpu.algorithms import build_agent as j_build_agent

    agent_cfg, env_info, _ = slice_setup(fused=True)
    agent_cfg = dict(agent_cfg, critic_cfg=dict(agent_cfg["critic_cfg"], share_feature=True))
    j_agent = j_build_agent(dict(agent_cfg, env_params=env_info, seed=0))
    t_agent = t_build_agent(dict(agent_cfg, env_params=env_info, seed=0, device="cpu"))
    st = j_agent.train_state
    t_agent.load_params(params_from_jax(st.params, st.target_params, st.log_alpha))
    assert t_agent.model.share_feature and t_agent.model.average_grad
    pin_normal_by_shape(monkeypatch)
    batch = _batch()
    _compare_updates(j_agent, t_agent, lambda: _FixedMemory(batch))
    assert_params_track(j_agent, t_agent, N_UPDATES, 1e-3)


@pytest.mark.parametrize("average_grad", [True, False])
def test_share_feature_scales_the_input_gradient(average_grad):
    """Forward values unchanged; d(sum Q)/d(critic input) divided by num_q
    only with average_grad."""
    from pointcloud_rl_torch.models import build_actor_critic

    agent_cfg, env_info, _ = slice_setup(fused=False)
    actor_cfg = {k: v for k, v in agent_cfg["actor_cfg"].items() if k != "optim_cfg"}
    critic_cfg = {k: v for k, v in agent_cfg["critic_cfg"].items() if k != "optim_cfg"}
    grads, values = [], []
    for share in (False, True):
        model = build_actor_critic(actor_cfg, dict(critic_cfg, share_feature=share, average_grad=average_grad),
                                   env_info, shared_backbone=True, generator=torch.Generator().manual_seed(0))
        state = torch.randn(3, 32, generator=torch.Generator().manual_seed(1), requires_grad=True)
        feat = torch.randn(3, 16, generator=torch.Generator().manual_seed(2))
        q = model.critic_apply({"state": state}, actions=torch.zeros(3, 8), visual_feature=feat)
        q.sum().backward()
        grads.append(state.grad)
        values.append(q.detach())
    torch.testing.assert_close(values[1], values[0], rtol=0, atol=0)
    torch.testing.assert_close(grads[1], grads[0] / 2 if average_grad else grads[0], rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------- optimizers
OPTIMIZERS = {
    "adam": dict(type="Adam", lr=1e-2, betas=(0.5, 0.999)),
    "adam_weight_decay": dict(type="Adam", lr=1e-2, weight_decay=0.1),
    "adamw": dict(type="AdamW", lr=1e-2, weight_decay=0.05, eps=1e-6),
    "sgd": dict(type="SGD", lr=0.1),
    "sgd_momentum": dict(type="SGD", lr=0.05, momentum=0.9),
    "sgd_nesterov": dict(type="SGD", lr=0.05, momentum=0.9, nesterov=True),
    "rmsprop": dict(type="RMSprop", lr=1e-2),
    "rmsprop_momentum": dict(type="RMSprop", lr=1e-2, momentum=0.5, eps=1e-4),
    "adam_clipped": dict(type="Adam", lr=1e-2, max_grad_norm=3.0),
    "sgd_clipped_excluded": dict(type="SGD", lr=0.1, max_grad_norm=2.0, param_cfg={"^b/": None}),
}
STEPS = 6


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_steps_like_optax(name):
    """Six steps of each branch on the same parameters and gradients (the
    gradients' global norm crosses ``max_grad_norm`` both ways).  f32
    updates in another order: 1e-6 relative, plus Adam's sign-sensitive
    first steps where a gradient is ~0 (none here)."""
    from pointcloud_rl_torch.algorithms.optim import Optimizer
    from pointcloud_rl_tpu.algorithms.optim import make_optimizer

    cfg = OPTIMIZERS[name]
    rs = np.random.RandomState(0)
    params = {"a": {"kernel": rs.randn(4, 3).astype(np.float32)}, "b": {"bias": rs.randn(3).astype(np.float32)}}
    tx = make_optimizer(dict(cfg), params)
    opt_state = tx.init(params)
    t_params = {"a.kernel": torch.tensor(params["a"]["kernel"]), "b.bias": torch.tensor(params["b"]["bias"])}
    t_opt = Optimizer(dict(cfg), list(t_params.items()))
    assert t_opt.names == (["a.kernel"] if "param_cfg" in cfg else ["a.kernel", "b.bias"])
    for step in range(STEPS):
        scale = 0.3 if step % 2 else 2.0
        grads = {"a": {"kernel": (rs.randn(4, 3) * scale).astype(np.float32)},
                 "b": {"bias": (rs.randn(3) * scale).astype(np.float32)}}
        upd, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, upd)
        by_name = {"a.kernel": grads["a"]["kernel"], "b.bias": grads["b"]["bias"]}
        t_opt.step([torch.tensor(by_name[n]) for n in t_opt.names])
    for key, sub in (("a.kernel", ("a", "kernel")), ("b.bias", ("b", "bias"))):
        np.testing.assert_allclose(t_params[key].numpy(), np.asarray(params[sub[0]][sub[1]]), rtol=1e-5, atol=1e-6,
                                   err_msg=f"{name} {key}")


def test_unknown_optimizer_options_raise():
    from pointcloud_rl_torch.algorithms.optim import Optimizer

    with pytest.raises(KeyError):
        Optimizer(dict(type="Lion"), [("w", torch.zeros(2))])
    with pytest.raises(NotImplementedError):
        Optimizer(dict(type="Adam", amsgrad=True), [("w", torch.zeros(2))])


# --------------------------------------------------------------- schedulers
SCHEDULES = [
    dict(type="Step", value=1.0, milestones=[10, 20], gamma=0.5),
    dict(type="StepScheduler", value=2.0, milestones=[5], gamma=0.1),
    dict(type="KeyStep", keys=[0, 100], values=[0.3, 0.1]),
    dict(type="Fixed", value=0.25),
    dict(type="Lmbda", value=2.0, fn="lambda t: 1 / (1 + t)"),
    0.7,
]
LR_SCHEDULES = [
    dict(type="cosine", value=1e-3, decay_steps=100),
    dict(type="CosineAnnealing", value=0.5, decay_steps=30, alpha=0.1),
    dict(type="linear", value=1.0, end_value=0.0, decay_steps=10),
    dict(type="LinearDecay", value=0.3, end_value=0.1, decay_steps=40),
    dict(type="exponential", value=1e-2, decay_steps=10),
    dict(type="ExponentialDecay", value=1.0, decay_steps=7, gamma=0.5),
    dict(type="Step", value=1.0, milestones=[3], gamma=0.5),
    5e-4,
]
STEPS_TO_CHECK = [0, 1, 3, 5, 7, 10, 15, 29, 30, 55, 99, 100, 150, 500]


@pytest.mark.parametrize("cfg", SCHEDULES, ids=lambda c: c["type"] if isinstance(c, dict) else "number")
def test_scheduler_matches_jax(cfg):
    from pointcloud_rl_torch.schedulers import build_scheduler as t_build
    from pointcloud_rl_tpu.schedulers import build_scheduler as j_build

    t, j = t_build(cfg), j_build(cfg)
    for step in STEPS_TO_CHECK:
        assert t.get(step) == j.get(step) and t(step) == j(step), step


@pytest.mark.parametrize("cfg", LR_SCHEDULES, ids=lambda c: c["type"] if isinstance(c, dict) else "number")
def test_lr_schedule_matches_optax(cfg):
    from pointcloud_rl_torch.schedulers import build_lr_schedule as t_build
    from pointcloud_rl_tpu.schedulers import build_lr_schedule as j_build

    t, j = t_build(cfg), j_build(cfg)
    if not isinstance(cfg, dict):
        assert t == j == cfg
        return
    for step in STEPS_TO_CHECK:
        # optax computes in f32: a few ulps of the schedule's scale (its
        # initial value) apart from the port's f64, also where it decays to ~0
        want = float(j(jnp.asarray(step)))
        np.testing.assert_allclose(t(step), want, rtol=1e-6, atol=1e-6 * cfg["value"], err_msg=f"{cfg} at {step}")
    assert t_build(None) is None
