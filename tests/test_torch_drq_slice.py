"""The DrQ slice end to end on the CPU, in both storage modes: the
``run_rl`` CLI trains ``pn_jitter_fake_manipulation.py`` at test size,
evaluates from its final checkpoint and auto-resumes.

(a) host replay, the config as it is;
(b) ``DeviceReplayMemory`` with ``pack_features`` storage and the bf16
    agent flag (here the "device" is the CPU).
"""

import json
import os
import os.path as osp
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, osp.dirname(__file__))

from test_torch_models import DRQ_CONFIG, TINY_CLI  # noqa: E402

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
MODES = {
    "host_replay": [],
    "device_replay_bf16": ["replay_cfg.type=DeviceReplayMemory", "replay_cfg.transfer_cfg.pack_features=True",
                           "agent_cfg.bf16=True"],
}


def _run(work_dir, mode, *extra, opts=()):
    from pointcloud_rl_torch.apis import run_rl

    run_rl.main([DRQ_CONFIG, "--work-dir", str(work_dir), "--seed", "0", "--device", "cpu",
                 *extra, "--cfg-options", *_OPTS, *MODES[mode], *opts])
    with open(osp.join(work_dir, "0", "run_summary.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_drq_trains_evaluates_and_auto_resumes(mode, tmp_path):
    wd = tmp_path / "wd"
    models = wd / "0" / "models"
    out = _run(wd, mode, opts=["train_cfg.total_steps=96"])
    assert out["device"] == "cpu" and out["steps"] == 96 and out["grad_steps"] == 16
    assert sorted(os.listdir(models)) == ["model_64", "model_final"]
    with open(wd / "0" / "logs" / "metrics.csv") as f:
        rows = f.read().splitlines()
    header = rows[0].split(",")
    assert "train/drq/critic_loss" in header
    col = header.index("train/drq/critic_loss")
    losses = [float(r.split(",")[col]) for r in rows[1:] if r.split(",")[col]]
    assert losses and all(np.isfinite(losses))
    replay = out["replay"]
    if mode == "host_replay":
        assert replay["type"] == "ReplayMemory" and replay["device"] == "cpu"
    else:
        assert replay["type"] == "DeviceReplayMemory" and replay["device"] == "cpu"
        # obs and next_obs as [1200 -> 64 points, 8] bf16 plus a 32-dim f32 state, 500 rows
        assert replay["storage_bytes"] >= 500 * 2 * (64 * 8 * 2 + 32 * 4)
    assert replay["size"] == 96 and replay["storage_bytes"] > 0

    ev = _run(wd, mode, "--evaluation", "--resume-from", str(models / "model_final"))
    assert set(ev["eval"]) == {"rewards_mean", "lengths_mean", "success_rate"}
    assert all(np.isfinite(v) for v in ev["eval"].values())

    # a resume without a replay snapshot refills the replay off the budget
    rs = _run(wd, mode, "--auto-resume", opts=["train_cfg.total_steps=128"])
    assert rs["resume_steps"] == 64 and rs["steps"] == 128 and rs["replay"]["size"] == 32 + 64
    assert "model_128" in os.listdir(models)
