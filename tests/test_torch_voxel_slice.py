"""The voxel slice: DrQ + ``SparseCNN`` (the dense voxel encoder) on
``sparse_conv_shift_fake_manipulation.py``.

1. DrQ's update with the voxel encoder against the JAX package's, step for
   step over 4 updates (as ``tests/test_torch_drq.py`` does for PointNet):
   the port's parameters come from the JAX agent through
   ``params_from_jax``, the Gaussian noise is pinned to zero and the
   shift's draw to the same fixed values on both sides (the n-th
   augmentation call of an update gets the n-th shift).
2. The ``run_rl`` CLI trains the config at test size on the CPU, evaluates
   from its final checkpoint and auto-resumes, in fresh processes.
"""

import json
import os
import os.path as osp
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, osp.dirname(__file__))

from test_torch_drq import _assert_params_match, _run_updates  # noqa: E402
from test_torch_models import TINY, TINY_CLI  # noqa: E402
from test_torch_sac import B, METRIC_RTOL, N_UPDATES, _batch, _FixedMemory, _pin_noise  # noqa: E402

from pointcloud_rl_torch.convert import params_from_jax  # noqa: E402
from pointcloud_rl_torch.ops import augment as ta  # noqa: E402
from pointcloud_rl_tpu.config import Config  # noqa: E402
from pointcloud_rl_tpu.ops import augment as ja  # noqa: E402

torch.set_num_threads(1)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
VOXEL_CONFIG = osp.join(REPO, "configs/mfrl/drq/synthetic/sparse_conv_shift_fake_manipulation.py")
_V = "agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg."
# The tiny slice's widths (TINY: conv widths [16, 16, 32] -> 16, heads 32
# wide, batch 16, 64 points) on an 8^3 grid with a narrow stem.
VOXEL_TINY = dict(TINY, **{_V + "grid_size": [8, 8, 8], _V + "stem_channels": [8, 8]})
VOXEL_TINY_CLI = TINY_CLI + [f"{_V}grid_size=[8,8,8]", f"{_V}stem_channels=[8,8]"]


def voxel_setup(**agent_overrides):
    """(resolved agent_cfg, env_info) of the voxel config at test size."""
    from pointcloud_rl_torch.env import get_env_info
    from pointcloud_rl_torch.models import get_kwargs_from_shape, replace_placeholder_with_args

    cfg = Config.fromfile(VOXEL_CONFIG)
    cfg.merge_from_dict(VOXEL_TINY)
    env_info = get_env_info(dict(cfg["env_cfg"]))
    kwargs = get_kwargs_from_shape(env_info["obs_shape"], env_info["action_shape"])
    agent_cfg = dict(replace_placeholder_with_args(dict(cfg["agent_cfg"]), **kwargs))
    agent_cfg.update(agent_overrides)
    return agent_cfg, env_info


def _pin_shift(monkeypatch):
    """Both packages' shift draw returns fixed per-row shifts for the n-th
    call of an update (two per DrQ update: obs, then next_obs)."""
    rs = np.random.RandomState(0)
    shifts = [rs.uniform(-0.1, 0.1, (2 * B, 3)).astype(np.float32) for _ in range(2)]
    counts = {"jax": 0, "torch": 0}

    def pinned(side, convert):
        def sample_info(self, generator, main_data):
            assert main_data.shape[0] == 2 * B
            i = counts[side] % 2
            counts[side] += 1
            return None, convert(shifts[i])
        return sample_info

    monkeypatch.setattr(ja.GlobalRotScaleTrans, "sample_info", pinned("jax", jnp.asarray))
    monkeypatch.setattr(ta.GlobalRotScaleTrans, "sample_info", pinned("torch", torch.from_numpy))
    return counts


def _voxel_batch():
    """The SAC tests' batch with xyz inside the 8^3 grid at 5 cm (and a few
    points past it, which the grid clips)."""
    batch = _batch()
    rs = np.random.RandomState(7)
    for key in ("obs", "next_obs"):
        batch[key] = dict(batch[key], xyz=rs.uniform(0.0, 0.45, batch[key]["xyz"].shape).astype(np.float32))
    return batch


def test_drq_voxel_updates_match_jax(monkeypatch):
    from pointcloud_rl_torch.algorithms import build_agent as t_build_agent
    from pointcloud_rl_tpu.algorithms import build_agent as j_build_agent

    _pin_noise(monkeypatch)
    counts = _pin_shift(monkeypatch)
    agent_cfg, env_info = voxel_setup()
    assert agent_cfg["actor_cfg"]["nn_cfg"]["visual_nn_cfg"]["type"] == "SparseCNN"
    j_agent = j_build_agent(dict(agent_cfg, env_params=env_info, seed=0))
    t_agent = t_build_agent(dict(agent_cfg, env_params=env_info, seed=0, device="cpu"))
    st = j_agent.train_state
    t_agent.load_params(params_from_jax(st.params, st.target_params, st.log_alpha))
    assert t_agent.num_aug == 2 and type(t_agent.model.visual).__name__ == "VoxelCNN"
    batch = _voxel_batch()
    _run_updates(j_agent, t_agent, _FixedMemory(batch), _FixedMemory(batch), N_UPDATES, "drq", METRIC_RTOL)
    assert counts["torch"] == 2 * N_UPDATES
    _assert_params_match(j_agent, t_agent, N_UPDATES)


_OPTS = VOXEL_TINY_CLI + [
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
    """One ``run_rl`` process on the CPU; returns its run_summary.json."""
    cmd = [sys.executable, "-m", "pointcloud_rl_torch.apis.run_rl", VOXEL_CONFIG, "--work-dir", str(work_dir),
           "--seed", "0", "--device", "cpu", *extra, "--cfg-options", *_OPTS, *opts]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(osp.join(work_dir, "0", "run_summary.json")) as f:
        return json.load(f)


def test_voxel_slice_trains_evaluates_and_auto_resumes(tmp_path):
    wd = tmp_path / "wd"
    models = wd / "0" / "models"
    no_pointnet = {"pointnet_fused_fwd_idx": 0, "pointnet_fused_fwd_max": 0}
    out = _run(wd, opts=["train_cfg.total_steps=96"])
    assert out["device"] == "cpu" and out["steps"] == 96 and out["grad_steps"] == 16
    assert out["launches"] == no_pointnet and out["pointcloud_rl_tpu_modules"] == []
    assert sorted(os.listdir(models)) == ["model_64", "model_final"]
    with open(wd / "0" / "logs" / "metrics.csv") as f:
        rows = f.read().splitlines()
    col = rows[0].split(",").index("train/drq/critic_loss")
    losses = [float(r.split(",")[col]) for r in rows[1:] if r.split(",")[col]]
    assert losses and all(np.isfinite(losses))

    ev = _run(wd, "--evaluation", "--resume-from", str(models / "model_final"))
    assert set(ev["eval"]) == {"rewards_mean", "lengths_mean", "success_rate"}
    assert all(np.isfinite(v) for v in ev["eval"].values()) and ev["launches"] == no_pointnet

    rs = _run(wd, "--auto-resume", opts=["train_cfg.total_steps=128"])
    assert rs["resume_steps"] == 64 and rs["steps"] == 128 and rs["pointcloud_rl_tpu_modules"] == []
    assert "model_128" in os.listdir(models)


@pytest.mark.parametrize("impl", ["dense", "sparse"])
def test_voxel_agent_acts_from_env_observations(impl):
    """The act path (B = 1 and 4) on the env's own clouds, both impls."""
    from pointcloud_rl_torch.algorithms import build_agent
    from pointcloud_rl_torch.env import build_env

    agent_cfg, env_info = voxel_setup()
    agent_cfg["actor_cfg"]["nn_cfg"]["visual_nn_cfg"]["impl"] = impl
    agent = build_agent(dict(agent_cfg, env_params=env_info, seed=0, device="cpu"))
    cfg = Config.fromfile(VOXEL_CONFIG)
    cfg.merge_from_dict(VOXEL_TINY)
    env = build_env(dict(cfg["env_cfg"]))
    env.seed(0)
    frames = [env.reset() for _ in range(4)]
    for n in (1, 4):
        obs = {k: np.stack([f[k] for f in frames[:n]]) for k in frames[0]}
        act = agent.forward(obs, mode="eval")
        assert act.shape == (n, env_info["action_shape"]) and np.isfinite(act).all()
