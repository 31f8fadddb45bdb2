"""The port runs where JAX is not installed.

The card's machine has PyTorch but no jax, flax, optax, orbax, h5py,
tensorboardX, dm_control or MuJoCo, and the port imports nothing of the
JAX package either.  A ``sitecustomize`` on the subprocesses' path makes
every one of those imports (``pointcloud_rl_tpu`` included) fail, in the process
and in every process it starts (the env workers included); then every
``pointcloud_rl_torch`` module is imported and the slices' CLI takes a few
CPU steps with two env worker processes: SAC on a host replay, DrQ on
a ``DeviceReplayMemory`` with packed bf16 storage and the bf16 agent flag,
and DrQ with the voxel encoder, and SAC on two data-parallel gloo ranks;
and the DMC path below the simulator (the
device fusion of raw renders, the walker recipe's agent with its obs
transfer, a packed device replay, an update) runs with dm_control blocked.
"""

import json
import os
import os.path as osp
import subprocess
import sys
import textwrap

import torch

sys.path.insert(0, osp.dirname(__file__))

import pytest  # noqa: E402
from test_torch_models import DRQ_CONFIG, SLICE_CONFIG, TINY_CLI  # noqa: E402
from test_torch_recurrent import RNN_CLI  # noqa: E402
from test_torch_voxel_slice import VOXEL_CONFIG, VOXEL_TINY_CLI  # noqa: E402

torch.set_num_threads(1)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "h5py", "tensorboardX", "dm_control", "mujoco",
           "pointcloud_rl_tpu")

_BLOCKER = textwrap.dedent(f"""
    import importlib.abc
    import sys

    BLOCKED = {BLOCKED!r}

    class _Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{{name}} is blocked: the card's machine does not have it")

    sys.meta_path.insert(0, _Block())
""")


def _env(tmp_path):
    (tmp_path / "sitecustomize.py").write_text(_BLOCKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), REPO])
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_every_module_imports_without_jax(tmp_path):
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        import pointcloud_rl_torch
        names = [m.name for m in pkgutil.walk_packages(pointcloud_rl_torch.__path__, "pointcloud_rl_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules if m.split(".")[0] in %r)
        assert not bad, bad
        print(len(names))
    """ % (BLOCKED,))
    out = subprocess.run([sys.executable, "-c", script], env=_env(tmp_path), cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    # every module of the package was imported (73 with the DMC env, the
    # server env, the fusion, camera and sampling ops, parallel/ and
    # utils/draws.py)
    assert int(out.stdout.split()[-1]) >= 73


_FUSED = "agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.fused=True"
SLICES = {
    "sac": (SLICE_CONFIG, TINY_CLI + [_FUSED], "sac"),
    "drq_device_replay_bf16": (DRQ_CONFIG, TINY_CLI + [_FUSED, "replay_cfg.type=DeviceReplayMemory",
                                                       "replay_cfg.transfer_cfg.pack_features=True",
                                                       "agent_cfg.bf16=True"], "drq"),
    "drq_voxel": (VOXEL_CONFIG, VOXEL_TINY_CLI, "drq"),
    # warm-up past the env's 50-step episodes, so windows can be drawn
    "sac_rnn": (SLICE_CONFIG, TINY_CLI + [_FUSED] + RNN_CLI + ["agent_cfg.batch_size=8", "train_cfg.warm_steps=112",
                                                              "train_cfg.total_steps=128"], "sac"),
    "ddpg": (SLICE_CONFIG, TINY_CLI + [_FUSED, "agent_cfg.type=DDPG"], "ddpg"),
    # data parallel: two spawned gloo ranks (the flag ends --cfg-options)
    "sac_two_ranks": (SLICE_CONFIG, TINY_CLI + [_FUSED, "--num-devices", "2"], "sac"),
}


@pytest.mark.parametrize("name", sorted(SLICES))
def test_slice_trains_without_jax(name, tmp_path):
    config, extra, prefix = SLICES[name]
    wd = tmp_path / "wd"
    cmd = [sys.executable, "-m", "pointcloud_rl_torch.apis.run_rl", config,
           "--work-dir", str(wd), "--seed", "0", "--device", "cpu", "--cfg-options", "replay_cfg.capacity=500",
           "train_cfg.total_steps=48", "train_cfg.warm_steps=32", "train_cfg.n_log=16",
           "train_cfg.exp_logger_cfg.type=csv", "rollout_cfg.num_procs=2", "eval_cfg.num_procs=1", *extra]
    out = subprocess.run(cmd, env=_env(tmp_path), cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert osp.isfile(wd / "0" / "models" / "model_final")
    assert f"{prefix}/critic_loss" in (wd / "0" / "logs" / "metrics.csv").read_text().splitlines()[0]
    summary = json.loads((wd / "0" / "run_summary.json").read_text())
    assert summary["pointcloud_rl_tpu_modules"] == []


_DMC_PATH = textwrap.dedent("""
    import numpy as np
    from pointcloud_rl_torch.algorithms import build_agent
    from pointcloud_rl_torch.apis.run_rl import load_config, resolve_agent_placeholders
    from pointcloud_rl_torch.env import build_replay
    from pointcloud_rl_torch.env.server_env import ServerObsVectorEnv
    from pointcloud_rl_torch.env.spaces import Box

    class Inner:  # raw renders of 2 envs x 3 frames, as DMC workers in obs_mode="raw" ship them
        num_envs = 2
        attrs = dict(n_points=16, num_ground=4, ground_eps=8e-3, max_depth=5.0, z_to_world=True,
                     fix_base_z=None, inv_intrinsic=np.linalg.inv([[10.0, 0, 3.5], [0, 10.0, 3.5], [0, 0, 1.0]]))

        def get_attr(self, name, idx=None):
            return self.attrs[name]

        def reset(self, idx=None, **kwargs):
            rs = np.random.RandomState(0)
            cam = np.zeros((2, 3, 1, 12), np.float32)
            cam[..., :9] = np.eye(3, dtype=np.float32).reshape(-1)
            return {"depth": rs.uniform(0.5, 6.0, (2, 3, 8, 8)).astype(np.float32),
                    "rgb": rs.randint(0, 256, (2, 9, 8, 8)).astype(np.uint8), "cam": cam}

    obs = ServerObsVectorEnv(Inner(), num_frames=3, seed=0, device="cpu").reset()
    info = dict(obs_shape={k: v.shape[1:] for k, v in obs.items()}, action_shape=6, is_discrete=False,
                action_space=Box(-np.ones(6, np.float32), np.ones(6, np.float32)))
    cfg = load_config("configs/mfrl/sac/dm_control/pn_walker_tpu.py", {
        "agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.mlp_spec": [8, 8, 16],
        "agent_cfg.actor_cfg.nn_cfg.mlp_cfg.mlp_spec": [50, 16, 16, "action_shape * 2"],
        "agent_cfg.critic_cfg.nn_cfg.mlp_cfg.mlp_spec": ["50 + action_shape", 16, 16, 1],
        "agent_cfg.batch_size": 4, "replay_cfg.capacity": 8})
    resolve_agent_placeholders(cfg, info)
    agent = build_agent(dict(cfg["agent_cfg"], env_params=info, seed=0, device="cpu"))
    assert agent.obs_transfer.drop_pos_encoding and str(agent.obs_transfer.pack_dtype) == "float16"
    actions = agent.forward(obs, mode="explore")
    replay = build_replay(cfg["replay_cfg"], dict(seed=0), device=agent.device)
    replay.push_batch(dict(obs=obs, next_obs=obs, actions=actions, rewards=np.ones((2, 1), np.float32),
                           dones=np.zeros((2, 1), bool), episode_dones=np.zeros((2, 1), bool)))
    metrics = agent.update_parameters(replay, 1)
    assert np.isfinite(metrics["sac/critic_loss"]), metrics
    print("dmc path ok", sorted(replay.storage["obs"]))
""")


def test_dmc_path_runs_without_jax_and_dm_control(tmp_path):
    out = subprocess.run([sys.executable, "-c", _DMC_PATH], env=_env(tmp_path), cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "dmc path ok ['pcd']" in out.stdout
