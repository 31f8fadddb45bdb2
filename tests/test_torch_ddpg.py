"""The port's DDPG / TD3 against the JAX package's.

Both agents are built from ``pn_fake_manipulation.py`` at test size with
``type=DDPG``, the port's parameters (the target actor included) come from
the JAX agent through ``params_from_jax``, and a fixed batch feeds both.
The Gaussian draws (TD3's target smoothing, the exploration noise) are
injected: the JAX module's ``jax.random.normal`` and the port's
``standard_normal`` return the same numpy array.  Four updates exercise
the actor and target gates of interval 2.
"""

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

from test_torch_models import SLICE_CONFIG, TINY_CLI, slice_obs, slice_setup  # noqa: E402
from test_torch_recurrent import assert_params_track  # noqa: E402
from test_torch_sac import B, _batch, _FixedMemory  # noqa: E402

from pointcloud_rl_torch.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)

A = 8
N_UPDATES = 4
LR = 1e-3
METRIC_RTOL = 1e-3  # f32 sums in another order, through 4 updates


def pin_noise(monkeypatch, seed=5):
    """The DDPG modules' normal draws of each shape return one fixed array."""
    from pointcloud_rl_torch.algorithms import ddpg as t_ddpg
    from pointcloud_rl_tpu.algorithms import ddpg as j_ddpg

    rs = np.random.RandomState(seed)
    table = {}

    def draw(shape):
        shape = tuple(int(d) for d in shape)
        if shape not in table:
            table[shape] = rs.randn(*shape).astype(np.float32)
        return table[shape]

    class _Random:
        def __getattr__(self, name):
            return getattr(jax.random, name)

        @staticmethod
        def normal(key, shape, dtype=jnp.float32):
            return jnp.asarray(draw(shape), dtype)

    class _Jax:
        random = _Random()

        def __getattr__(self, name):
            return getattr(jax, name)

    monkeypatch.setattr(j_ddpg, "jax", _Jax())
    monkeypatch.setattr(t_ddpg, "standard_normal", lambda like, generator: torch.from_numpy(draw(like.shape)))
    return draw


def build_pair(**overrides):
    from pointcloud_rl_torch.algorithms import build_agent as t_build_agent
    from pointcloud_rl_tpu.algorithms import build_agent as j_build_agent

    agent_cfg, env_info, env_cfg = slice_setup(fused=True, type="DDPG", **overrides)
    j_agent = j_build_agent(dict(agent_cfg, env_params=env_info, seed=0))
    t_agent = t_build_agent(dict(agent_cfg, env_params=env_info, seed=0, device="cpu"))
    st = j_agent.train_state
    t_agent.load_params(params_from_jax(st.params, st.target_params, st.log_alpha))
    return j_agent, t_agent, env_cfg


@pytest.mark.parametrize("smoothing", [True, False], ids=["td3_smoothing", "ddpg"])
def test_ddpg_updates_match_jax(smoothing, monkeypatch):
    j_agent, t_agent, _ = build_pair(use_target_smoothing=smoothing)
    assert set(t_agent.target.keys()) == set(j_agent.train_state.target_params) == {"critic", "actor"}
    pin_noise(monkeypatch)
    batch = _batch()
    for u in range(N_UPDATES):
        j_m = j_agent.update_parameters(_FixedMemory(batch), updates=u)
        t_m = t_agent.update_parameters(_FixedMemory(batch), updates=u)
        actor_step = u % 2 == 0
        keys = ["critic_loss", "q", "q_target", "alpha", "critic_grad", "max_critic_abs_err"]
        keys += ["actor_loss", "actor_grad", "entropy", "alpha_loss"] if actor_step else []
        for key in keys:
            a, b = j_m[f"ddpg/{key}"], t_m[f"ddpg/{key}"]
            assert abs(a - b) < METRIC_RTOL * (1 + abs(a)), f"update {u} {key}: jax {a} vs torch {b}"
        assert sorted(t_m) == sorted(j_m)
    assert_params_track(j_agent, t_agent, N_UPDATES, LR)


def test_target_actor_tracks_the_live_actor_by_ema():
    """The target gate fires at update 0: every target-actor parameter
    becomes (1 - tau) * itself + tau * the post-update live actor, tau 0.01
    (the config's default rate; the actor matches no visual_nn regex)."""
    _, t_agent, _ = build_pair()
    assert all(t_agent.taus[n] == 0.01 for n in t_agent.taus if n.startswith("actor."))
    before = {k: v.clone() for k, v in t_agent.target["actor"].state_dict().items()}
    t_agent.update_parameters(_FixedMemory(_batch()), updates=0)
    live = t_agent.model.actor.state_dict()
    for name, value in t_agent.target["actor"].state_dict().items():
        want = before[name] * (1 - 0.01) + live[name] * 0.01
        torch.testing.assert_close(value, want, rtol=0, atol=1e-7)
    assert not any(p.requires_grad for p in t_agent.target.parameters())


def test_explore_adds_clipped_noise_like_jax(monkeypatch):
    j_agent, t_agent, _ = build_pair()
    draw = pin_noise(monkeypatch)
    obs = slice_obs(9, 3)
    want = np.asarray(j_agent.forward(obs, mode="explore"))
    got = t_agent.forward(obs, mode="explore")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    mean = t_agent.forward(obs, mode="eval")
    np.testing.assert_allclose(got, np.clip(mean + 0.1 * draw((3, A)), -1, 1), rtol=1e-5, atol=1e-6)


def _run(work_dir, *extra, opts=()):
    from pointcloud_rl_torch.apis import run_rl

    base = TINY_CLI + ["agent_cfg.type=DDPG", "agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.fused=True",
                       "replay_cfg.capacity=500", "train_cfg.warm_steps=32", "train_cfg.n_log=32",
                       "train_cfg.n_checkpoint=64", "train_cfg.exp_logger_cfg.type=csv", "rollout_cfg.num_procs=1",
                       "eval_cfg.save_video=False", "eval_cfg.num=1"]
    run_rl.main([SLICE_CONFIG, "--work-dir", str(work_dir), "--seed", "0", "--device", "cpu", *extra,
                 "--cfg-options", *base, *opts])
    with open(osp.join(work_dir, "0", "run_summary.json")) as f:
        return json.load(f)


def test_cli_trains_evaluates_and_auto_resumes(tmp_path):
    wd = tmp_path / "wd"
    models = wd / "0" / "models"
    out = _run(wd, opts=["train_cfg.total_steps=96"])
    assert out["device"] == "cpu" and out["steps"] == 96 and out["grad_steps"] == 16
    assert sorted(os.listdir(models)) == ["model_64", "model_final"]
    with open(wd / "0" / "logs" / "metrics.csv") as f:
        header = f.readline().strip().split(",")
    assert "train/ddpg/critic_loss" in header and "train/ddpg/actor_loss" in header
    ev = _run(wd, "--evaluation", "--resume-from", str(models / "model_final"))
    assert all(np.isfinite(v) for v in ev["eval"].values())
    rs = _run(wd, "--auto-resume", opts=["train_cfg.total_steps=128"])
    assert rs["resume_steps"] == 64 and rs["steps"] == 128
