"""The DM Control point-cloud config end to end on the CPU.

``run_rl`` trains ``configs/mfrl/sac/dm_control/pn.py`` (dmc_cheetah_run,
three stacked frames, SAC with the bf16 flag, ``obs_transfer_cfg`` with
the pos_encoding block re-synthesized, a ``DeviceReplayMemory`` that does
not store the block) at test size: 48 points per frame, 32 x 32 renders,
PointNet [16, 16, 32] -> 16, heads of 32, batch 16, a few dozen env steps.
Once on the env workers' own point-cloud sampler, once with
``env_cfg.server_obs=True`` (raw renders fused by ``ServerObsVectorEnv``
on the run's device, here the CPU).  The run must load nothing of the JAX
package.
"""

import json
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.dmc

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
DMC_CONFIG = osp.join(REPO, "configs/mfrl/sac/dm_control/pn.py")
DMC_TINY_CLI = [
    "env_cfg.n_points=48", "env_cfg.num_ground=16", "env_cfg.image_size=[32,32]",
    "agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.mlp_spec=[16,16,32]",
    "agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.out_channels=16",
    "agent_cfg.actor_cfg.nn_cfg.mlp_cfg.mlp_spec=[16,32,32,'action_shape * 2']",
    "agent_cfg.critic_cfg.nn_cfg.mlp_cfg.mlp_spec=['16 + action_shape',32,32,1]",
    "agent_cfg.batch_size=16", "replay_cfg.capacity=500",
    "train_cfg.total_steps=48", "train_cfg.warm_steps=16", "train_cfg.n_log=16",
    "train_cfg.exp_logger_cfg.type=csv", "eval_cfg.save_video=False",
]


def _dmc_available():
    try:
        from dm_control import suite  # noqa: F401

        return True
    except Exception:
        return False


@pytest.mark.skipif(not _dmc_available(), reason="dm_control unavailable")
@pytest.mark.parametrize("server_obs", [False, True], ids=["host_sampler", "server_obs"])
def test_dmc_config_trains_on_the_cpu(server_obs, tmp_path):
    """The CLI in a process of its own, so that the modules it loads are its
    own (and its env workers start from a forkserver)."""
    wd = tmp_path / "wd"
    extra = ["env_cfg.server_obs=True", "rollout_cfg.num_procs=2", "train_cfg.n_eval=48"] if server_obs \
        else ["rollout_cfg.num_procs=1"]
    cmd = [sys.executable, "-m", "pointcloud_rl_torch.apis.run_rl", DMC_CONFIG, "--work-dir", str(wd), "--seed", "0",
           "--device", "cpu", "--cfg-options", *DMC_TINY_CLI, *extra]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    summary = json.loads((wd / "0" / "run_summary.json").read_text())
    assert summary["device"] == "cpu" and summary["steps"] == 48 and summary["grad_steps"] == 32
    assert summary["pointcloud_rl_tpu_modules"] == []
    assert summary["replay"]["type"] == "DeviceReplayMemory"
    header, *rows = (wd / "0" / "logs" / "metrics.csv").read_text().splitlines()
    col = header.split(",").index("train/sac/critic_loss")
    assert rows and all(np.isfinite(float(r.split(",")[col])) for r in rows if r.split(",")[col])
    assert (wd / "0" / "models" / "model_final").is_file()
    if server_obs:  # the evaluation at step 48 ran on the same fused path
        col = header.split(",").index("test/rewards_mean")
        assert any(r.split(",")[col] and np.isfinite(float(r.split(",")[col])) for r in rows)
