"""The port's slice end to end on the CPU: the ``run_rl`` CLI trains the
SAC + PointNet fake-manipulation config at test size, evaluates from its
final checkpoint and auto-resumes; and a JAX agent's parameters, carried
across by ``params_from_jax``, act the same in both packages."""

import json
import os
import os.path as osp
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, osp.dirname(__file__))

from test_torch_models import SLICE_CONFIG, TINY_CLI, slice_setup  # noqa: E402

torch.set_num_threads(1)

_OPTS = TINY_CLI + [
    "agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.fused=True",
    "replay_cfg.capacity=500",
    "train_cfg.warm_steps=32",
    "train_cfg.n_log=32",
    "train_cfg.n_checkpoint=64",
    "train_cfg.exp_logger_cfg.type=csv",
    "rollout_cfg.num_procs=1",
    "eval_cfg.save_video=False",
    "eval_cfg.num=1",
]


def _run(work_dir, *extra, opts=()):
    from pointcloud_rl_torch.apis import run_rl

    run_rl.main([SLICE_CONFIG, "--work-dir", str(work_dir), "--seed", "0", "--device", "cpu",
                 *extra, "--cfg-options", *_OPTS, *opts])
    with open(osp.join(work_dir, "0", "run_summary.json")) as f:
        return json.load(f)


def test_train_evaluate_and_auto_resume(tmp_path):
    wd = tmp_path / "wd"
    models = wd / "0" / "models"
    out = _run(wd, opts=["train_cfg.total_steps=96"])
    assert out["device"] == "cpu" and out["steps"] == 96 and out["grad_steps"] == 16
    assert sorted(os.listdir(models)) == ["model_64", "model_final"]
    with open(wd / "0" / "logs" / "metrics.csv") as f:
        header = f.readline().strip().split(",")
    assert "train/sac/critic_loss" in header
    # CPU tensors never reach the CUDA kernel.
    assert out["launches"] == {"pointnet_fused_fwd_idx": 0, "pointnet_fused_fwd_max": 0}

    ev = _run(wd, "--evaluation", "--resume-from", str(models / "model_final"))
    assert set(ev["eval"]) == {"rewards_mean", "lengths_mean", "success_rate"}
    assert all(np.isfinite(v) for v in ev["eval"].values())

    rs = _run(wd, "--auto-resume", opts=["train_cfg.total_steps=128"])
    assert rs["resume_steps"] == 64 and rs["steps"] == 128
    assert "model_128" in os.listdir(models)


def test_checkpoint_round_trip_restores_the_train_state(tmp_path):
    from pointcloud_rl_torch.algorithms import build_agent
    from pointcloud_rl_torch.utils.checkpoint import find_checkpoint, load_checkpoint, save_checkpoint

    agent_cfg, env_info, _ = slice_setup()
    a = build_agent(dict(agent_cfg, env_params=env_info, seed=0, device="cpu"))
    b = build_agent(dict(agent_cfg, env_params=env_info, seed=1, device="cpu"))
    a.updates = 7
    save_checkpoint(a.state_dict(), str(tmp_path), 40)
    path, step = find_checkpoint(str(tmp_path))
    assert step == 40 and path.endswith("model_40")
    b.load_state_dict(load_checkpoint(path))
    assert b.updates == 7
    for (n, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), n
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_cuda_device_raises_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    from pointcloud_rl_torch.apis import run_rl

    with pytest.raises(RuntimeError, match="cuda"):
        run_rl.main([SLICE_CONFIG, "--work-dir", str(tmp_path), "--seed", "0", "--device", "cuda",
                     "--cfg-options", *_OPTS, "rollout_cfg.num_procs=1"])


def test_jax_params_give_the_same_eval_actions():
    """The whole slice's acting path: the JAX agent's parameters, converted,
    make the port's agent act as the JAX agent does (eval mode) on the
    environment's own observations."""
    from pointcloud_rl_torch.algorithms import build_agent as t_build_agent
    from pointcloud_rl_torch.convert import params_from_jax
    from pointcloud_rl_torch.env import build_env
    from pointcloud_rl_tpu.algorithms import build_agent as j_build_agent

    agent_cfg, env_info, env_cfg = slice_setup(fused=True)
    j_agent = j_build_agent(dict(agent_cfg, env_params=env_info, seed=0))
    t_agent = t_build_agent(dict(agent_cfg, env_params=env_info, seed=0, device="cpu"))
    st = j_agent.train_state
    t_agent.load_params(params_from_jax(st.params, st.target_params, st.log_alpha))

    env = build_env(env_cfg)
    env.seed(0)
    frames = [env.reset()]
    for _ in range(3):
        frames.append(env.step(env.action_space.sample())[0])
    obs = {k: np.stack([f[k] for f in frames]) for k in frames[0]}
    want = np.asarray(j_agent.forward(obs, mode="eval"))
    got = t_agent.forward(obs, mode="eval")
    assert got.shape == (4, 8)
    # f32 forwards through PointNet and a 3-layer head: ~1e-6 relative
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
