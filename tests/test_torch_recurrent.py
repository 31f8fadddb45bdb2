"""Recurrent SAC (a GRU between PointNet and the heads, T-step windows) in
the port against the JAX package's.

Both agents are built from ``pn_fake_manipulation.py`` at test size with
the recurrent recipe's overrides (``rnn_cfg`` GRU, ``TStepTransition``
windows), the port's parameters come from the JAX agent through
``params_from_jax``, and one fixed set of windows feeds both.  The
Gaussian draws are injected: the same numpy noise on both sides, one array
for the target's ``[B, H+1]`` sequence and one for the actor's ``[B, H]``.
Four updates exercise the actor and target gates of interval 2 (they fire
at updates 0 and 2).  Then the acting path with a threaded state and a
reset, and the CLI end to end on the CPU.
"""

import copy
import json
import os
import os.path as osp
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, osp.dirname(__file__))

from test_torch_models import SLICE_CONFIG, TINY_CLI, jax_leaf, slice_obs, slice_setup  # noqa: E402

from pointcloud_rl_torch.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)

B, H, A = 4, 3, 8
HIDDEN = 16  # the tiny slice's PointNet width, so the heads' "16 + agent_shape" fits
RNN = {"agent_cfg.actor_cfg.nn_cfg.rnn_cfg": {"type": "GRU", "hidden_size": HIDDEN}}
RNN_CLI = ["agent_cfg.actor_cfg.nn_cfg.rnn_cfg.type=GRU", f"agent_cfg.actor_cfg.nn_cfg.rnn_cfg.hidden_size={HIDDEN}",
           "replay_cfg.sampling_cfg.type=TStepTransition", "replay_cfg.sampling_cfg.horizon=8"]
N_UPDATES = 4
LR = 1e-3
METRIC_RTOL = 1e-3  # f32 sums in another order, through 4 updates


def rnn_setup(**overrides):
    agent_cfg, env_info, env_cfg = slice_setup(fused=True, **overrides)
    actor_cfg = copy.deepcopy(agent_cfg["actor_cfg"])
    actor_cfg["nn_cfg"]["rnn_cfg"] = dict(RNN["agent_cfg.actor_cfg.nn_cfg.rnn_cfg"])
    return dict(agent_cfg, actor_cfg=actor_cfg), env_info, env_cfg


class FixedWindows:
    """``sample_windows`` returning the same [B, H] windows every call."""

    def __init__(self, batch):
        self.batch = batch
        self.sampling = types.SimpleNamespace(horizon=H)

    def sample_windows(self, batch_size, horizon):
        assert (batch_size, horizon) == (B, H)
        return copy.deepcopy(self.batch)


def windows(seed=3):
    rs = np.random.RandomState(seed)

    def seq(s):
        return {k: v.reshape((B, H) + v.shape[1:]) for k, v in slice_obs(s, B * H).items()}

    is_valid = np.ones((B, H), bool)
    is_valid[1, 2:] = False  # a window padded past its episode's end
    is_valid[3, 1:] = False
    dones = np.zeros((B, H, 1), bool)
    dones[1, 1] = dones[3, 0] = True
    return dict(obs=seq(seed), next_obs=seq(seed + 1),
                actions=np.clip(rs.randn(B, H, A), -0.99, 0.99).astype(np.float32),
                rewards=rs.randn(B, H, 1).astype(np.float32), dones=dones, episode_dones=dones.copy(),
                is_valid=is_valid)


def pin_normal_by_shape(monkeypatch, seed=11):
    """Every standard normal draw of a given shape returns one fixed numpy
    array, on both sides (the JAX update is traced once, so each of its
    call sites keeps its array through the 4 updates, as the port's do)."""
    from pointcloud_rl_torch.models import distributions as td
    from pointcloud_rl_tpu.models import distributions as jd

    rs = np.random.RandomState(seed)
    table = {}

    def draw(shape):
        shape = tuple(int(d) for d in shape)
        if shape not in table:
            table[shape] = rs.randn(*shape).astype(np.float32)
        return table[shape]

    fake = types.SimpleNamespace(normal=lambda key, shape, dtype=None: jnp.asarray(draw(shape), dtype))
    monkeypatch.setattr(jd, "jax", types.SimpleNamespace(random=fake, nn=jax.nn))
    monkeypatch.setattr(td, "standard_normal", lambda like, generator: torch.from_numpy(draw(like.shape)))


def build_pair(**overrides):
    from pointcloud_rl_torch.algorithms import build_agent as t_build_agent
    from pointcloud_rl_tpu.algorithms import build_agent as j_build_agent

    agent_cfg, env_info, env_cfg = rnn_setup(**dict(dict(batch_size=B), **overrides))
    j_agent = j_build_agent(dict(agent_cfg, env_params=env_info, seed=0))
    t_agent = t_build_agent(dict(agent_cfg, env_params=env_info, seed=0, device="cpu"))
    st = j_agent.train_state
    t_agent.load_params(params_from_jax(st.params, st.target_params, st.log_alpha))
    return j_agent, t_agent, env_cfg


def assert_params_track(j_agent, t_agent, n_updates, lr):
    """Post-update parameters inside the Adam sign-flip envelope (see
    tests/test_torch_sac.py), >90% of elements tight; the target likewise."""
    envelope = 2 * lr * n_updates * 1.01
    params = jax.device_get(j_agent.train_state.params)
    target = jax.device_get(j_agent.train_state.target_params)
    for name, value in t_agent.model.state_dict().items():
        diff = np.abs(value.numpy() - jax_leaf(params, name))
        assert diff.max() < envelope, f"{name}: max diff {diff.max()} outside the Adam envelope"
        assert (diff < 1e-4).mean() > 0.9, f"{name}: only {(diff < 1e-4).mean():.2%} of elements tight"
    for name, value in t_agent.target.state_dict().items():
        diff = np.abs(value.numpy() - jax_leaf(target, name))
        assert diff.max() < envelope, f"target {name}: {diff.max()}"
    np.testing.assert_allclose(float(t_agent.log_alpha.detach()), float(j_agent.train_state.log_alpha), atol=1e-5)


@pytest.mark.parametrize("shared", [True, False], ids=["shared_backbone", "own_critic_encoder"])
def test_recurrent_updates_match_jax(shared, monkeypatch):
    """The shipped config shares the backbone (the critic trains encoder and
    rnn); without sharing the actor's optimizer owns them."""
    overrides = {} if shared else dict(shared_backbone=False, detach_actor_feature=False)
    j_agent, t_agent, _ = build_pair(**overrides)
    assert t_agent.model.is_recurrent and set(t_agent.target.keys()) == set(j_agent.train_state.target_params)
    pin_normal_by_shape(monkeypatch)
    batch = windows()
    for u in range(N_UPDATES):
        j_m = j_agent.update_parameters(FixedWindows(batch), updates=u)
        t_m = t_agent.update_parameters(FixedWindows(batch), updates=u)
        actor_step = u % 2 == 0
        keys = ["critic_loss", "q", "q_target", "alpha", "critic_grad", "max_critic_abs_err"]
        keys += ["actor_loss", "entropy", "actor_grad", "alpha_loss"] if actor_step else []
        for key in keys:
            a, b = j_m[f"sac/{key}"], t_m[f"sac/{key}"]
            assert abs(a - b) < METRIC_RTOL * (1 + abs(a)), f"update {u} {key}: jax {a} vs torch {b}"
        assert ("sac/actor_loss" in t_m) == actor_step and sorted(t_m) == sorted(j_m)
    assert t_agent.updates == N_UPDATES
    assert_params_track(j_agent, t_agent, N_UPDATES, LR)


def test_act_threads_the_state_and_resets_done_rows():
    """Eval actions over a sequence of steps, the rnn state carried from
    step to step and zeroed for the envs whose episode ended, against the
    JAX agent's ``forward`` / ``reset_rnn_states``."""
    j_agent, t_agent, _ = build_pair()
    n_env, steps = 3, 5
    frames = [slice_obs(20 + t, n_env) for t in range(steps)]
    dones_at = {2: np.array([[True], [False], [True]])}
    for t, obs in enumerate(frames):
        want = np.asarray(j_agent.forward(obs, mode="eval"))
        got = t_agent.forward(obs, mode="eval")
        assert got.shape == (n_env, A)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=f"step {t}")
        np.testing.assert_allclose(t_agent._rnn_states.numpy(), np.asarray(j_agent._rnn_states),
                                   rtol=1e-5, atol=1e-6)
        if t in dones_at:
            before = t_agent._rnn_states.clone()
            j_agent.reset_rnn_states(dones_at[t])
            t_agent.reset_rnn_states(dones_at[t])
            after = t_agent._rnn_states
            assert torch.all(after[0] == 0) and torch.all(after[2] == 0)
            assert torch.equal(after[1], before[1]) and bool(before[1].abs().sum() > 0)
    t_agent.reset_rnn_states()
    assert t_agent._rnn_states is None


def test_recurrent_update_encodes_b_times_t_rows(monkeypatch):
    """The windows reach the PointNet kernel flattened to B*H (critic, with
    the argmax) and B*(H+1) rows (target: once, the target critic reuses
    the actor's feature), and the actor re-encodes the obs (max-only)
    although the config sets stale_actor_feature."""
    from pointcloud_rl_torch.ops import pointnet_fused as tpf

    calls = []
    plain = tpf._forward_plain

    def checked(x, params, compute_dtype, with_idx=True):
        tpf._kernel_inputs(x, params, compute_dtype)
        calls.append((x.shape[0], with_idx))
        return plain(x, params, compute_dtype, with_idx)

    _, t_agent, _ = build_pair()
    monkeypatch.setattr(tpf, "_forward_plain", checked)
    assert t_agent.stale_actor_feature
    t_agent.update_parameters(FixedWindows(windows()), updates=0)
    assert sorted(calls) == sorted([(B * (H + 1), False), (B * H, True), (B * H, False)])


def _run(work_dir, *extra, opts=()):
    from pointcloud_rl_torch.apis import run_rl

    base = TINY_CLI + RNN_CLI + [
        "agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.fused=True", "agent_cfg.batch_size=8", "replay_cfg.capacity=1000",
        "train_cfg.warm_steps=64", "train_cfg.n_log=32", "train_cfg.n_checkpoint=80",
        "train_cfg.exp_logger_cfg.type=csv", "rollout_cfg.num_procs=1", "eval_cfg.save_video=False",
        "eval_cfg.num=1"]
    run_rl.main([SLICE_CONFIG, "--work-dir", str(work_dir), "--seed", "0", "--device", "cpu", *extra,
                 "--cfg-options", *base, *opts])
    with open(osp.join(work_dir, "0", "run_summary.json")) as f:
        return json.load(f)


def test_cli_trains_evaluates_and_auto_resumes(tmp_path):
    """The recurrent recipe through ``run_rl`` on the CPU: warm-up (64
    steps) past the env's 50-step episodes, so windows can be drawn."""
    wd = tmp_path / "wd"
    models = wd / "0" / "models"
    out = _run(wd, opts=["train_cfg.total_steps=96"])
    assert out["device"] == "cpu" and out["steps"] == 96 and out["grad_steps"] == 8
    assert out["launches"] == {"pointnet_fused_fwd_idx": 0, "pointnet_fused_fwd_max": 0}  # CPU tensors
    assert sorted(os.listdir(models)) == ["model_80", "model_final"]
    with open(wd / "0" / "logs" / "metrics.csv") as f:
        header = f.readline().strip().split(",")
    assert "train/sac/critic_loss" in header
    ev = _run(wd, "--evaluation", "--resume-from", str(models / "model_final"))
    assert all(np.isfinite(v) for v in ev["eval"].values())
    # a cold resume refills min(warm, left) = 64 steps with the policy:
    # again one whole episode before the first window is drawn
    rs = _run(wd, "--auto-resume", opts=["train_cfg.total_steps=144"])
    assert rs["resume_steps"] == 80 and rs["steps"] == 144
