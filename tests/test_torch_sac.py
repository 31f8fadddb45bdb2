"""The port's SAC update against the JAX package's, step for step.

Both agents are built from ``pn_fake_manipulation.py`` at test size, the
port's parameters come from the JAX agent through ``params_from_jax``, a
fixed-batch memory feeds both, and the Gaussian sampling noise is pinned
to zero on both sides (on the JAX side exactly as
``tests/test_golden_update.py`` pins it).  Four updates exercise the
actor and target gating of interval 2 at updates 0 and 2.
"""

import os.path as osp
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, osp.dirname(__file__))

from test_torch_models import jax_leaf, slice_obs, slice_setup  # noqa: E402

from pointcloud_rl_torch.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)

B = 16  # the tiny slice's batch size
N_UPDATES = 4
LR = 1e-3  # the slice config's actor and critic Adam lr
# Losses and statistics: f32 sums in another order, through 4 updates.
METRIC_RTOL = 1e-3


class _FixedMemory:
    """memory.sample() returning the SAME batch every call."""

    def __init__(self, batch):
        self.batch = batch

    def __len__(self):
        return B

    def sample(self, batch_size):
        import copy

        return copy.deepcopy(self.batch)


def _batch(seed=3):
    rs = np.random.RandomState(seed)
    return dict(
        obs=slice_obs(seed, B),
        next_obs=slice_obs(seed + 1, B),
        actions=np.clip(rs.randn(B, 8), -0.99, 0.99).astype(np.float32),
        rewards=rs.randn(B, 1).astype(np.float32),
        dones=(rs.rand(B, 1) < 0.2),
        episode_dones=np.zeros((B, 1), bool),
    )


def _pin_noise(monkeypatch):
    from pointcloud_rl_torch.models import distributions as td
    from pointcloud_rl_torch.models import heads as t_heads
    from pointcloud_rl_tpu.models import heads as j_heads
    from pointcloud_rl_tpu.models.distributions import tanh_log_prob_with_logit, tanh_transform

    def j_zero(key, mean, std, scale, bias, epsilon=1e-6):
        return tanh_transform(mean, scale, bias), tanh_log_prob_with_logit(mean, mean, std, scale, epsilon)

    def t_zero(generator, mean, std, scale, bias, epsilon=1e-6):
        return td.tanh_transform(mean, scale, bias), td.tanh_log_prob_with_logit(mean, mean, std, scale, epsilon)

    monkeypatch.setattr(j_heads, "tanh_normal_rsample_with_log_prob", j_zero)
    monkeypatch.setattr(t_heads, "tanh_normal_rsample_with_log_prob", t_zero)


@pytest.mark.parametrize("stale", [True, False], ids=["stale_feature", "fresh_feature"])
def test_sac_updates_match_jax(stale, monkeypatch):
    from pointcloud_rl_torch.algorithms import build_agent as t_build_agent
    from pointcloud_rl_tpu.algorithms import build_agent as j_build_agent

    _pin_noise(monkeypatch)
    agent_cfg, env_info, _ = slice_setup(fused=True, stale_actor_feature=stale)
    j_agent = j_build_agent(dict(agent_cfg, env_params=env_info, seed=0))
    t_agent = t_build_agent(dict(agent_cfg, env_params=env_info, seed=0, device="cpu"))
    st = j_agent.train_state
    t_agent.load_params(params_from_jax(st.params, st.target_params, st.log_alpha))

    batch = _batch()
    for u in range(N_UPDATES):
        j_metrics = j_agent.update_parameters(_FixedMemory(batch), updates=u)
        t_metrics = t_agent.update_parameters(_FixedMemory(batch), updates=u)
        actor_step = u % 2 == 0
        keys = ["critic_loss", "q", "q_target", "alpha"] + (["actor_loss", "entropy"] if actor_step else [])
        for key in keys:
            a, b = j_metrics[f"sac/{key}"], t_metrics[f"sac/{key}"]
            assert abs(a - b) < METRIC_RTOL * (1 + abs(a)), f"update {u} {key}: jax {a} vs torch {b}"
        assert ("sac/actor_loss" in t_metrics) == actor_step
    assert t_agent.updates == N_UPDATES

    # Post-update parameters.  Where a gradient element is ~0, f32 noise
    # flips the SIGN of Adam's first bias-corrected step (+-lr whatever
    # |grad|), so element-wise diffs up to 2*lr*updates are inherent; a
    # semantic fault moves MOST elements.  Hence: every element inside that
    # envelope, and >90% of elements tight (tests/test_golden_update.py:196-210).
    envelope = 2 * LR * N_UPDATES * 1.01
    params, target = jax.device_get(j_agent.train_state.params), jax.device_get(j_agent.train_state.target_params)
    for name, value in t_agent.model.state_dict().items():
        diff = np.abs(value.numpy() - jax_leaf(params, name))
        assert diff.max() < envelope, f"{name}: max diff {diff.max()} outside the Adam envelope"
        assert (diff < 1e-4).mean() > 0.9, f"{name}: only {(diff < 1e-4).mean():.2%} of elements tight"
    # The target moved by EMA (tau 0.01) of the live critic at updates 0 and 2.
    for name, value in t_agent.target.state_dict().items():
        diff = np.abs(value.numpy() - jax_leaf(target, name))
        assert diff.max() < envelope * 0.02, f"target {name}: {diff.max()}"
    np.testing.assert_allclose(float(t_agent.log_alpha.detach()), float(j_agent.train_state.log_alpha), atol=1e-5)


def test_update_and_act_pass_what_the_kernel_takes(monkeypatch):
    """Every fused-body call of an update and an act satisfies the CUDA
    wrapper's checks (dtype, shape, contiguity), which only a card would
    otherwise exercise."""
    from pointcloud_rl_torch.algorithms import build_agent
    from pointcloud_rl_torch.ops import pointnet_fused as tpf

    calls = []
    plain = tpf._forward_plain

    def checked(x, params, compute_dtype, with_idx=True):
        tpf._kernel_inputs(x, params, compute_dtype)
        calls.append(with_idx)
        return plain(x, params, compute_dtype, with_idx)

    monkeypatch.setattr(tpf, "_forward_plain", checked)
    agent_cfg, env_info, _ = slice_setup(fused=True)
    agent = build_agent(dict(agent_cfg, env_params=env_info, seed=0, device="cpu"))
    agent.update_parameters(_FixedMemory(_batch()), updates=0)
    agent.forward(slice_obs(5, 2), mode="explore")
    # critic encode with the argmax; q-target and act encodes max-only
    assert sorted(calls) == [False, False, True]


def test_actor_step_moves_neither_critic_nor_encoder():
    """The actor optimizer owns the actor head only (the config excludes
    visual_nn and the backbone is shared); the critic's owns critic and encoder."""
    agent_cfg, env_info, _ = slice_setup(fused=True)
    from pointcloud_rl_torch.algorithms import build_agent

    agent = build_agent(dict(agent_cfg, env_params=env_info, seed=0, device="cpu"))
    assert all(n.startswith("actor.") for n in agent.actor_tx.names)
    assert {n.split(".")[0] for n in agent.critic_tx.names} == {"critic", "visual"}
    assert agent.taus and set(agent.taus.values()) == {0.01}  # the target holds only the critic
