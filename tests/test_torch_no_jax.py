"""The port runs where JAX is not installed.

The card's machine has PyTorch but no jax, flax, optax, orbax, h5py,
tensorboardX, dm_control or MuJoCo, and the port imports nothing of the
JAX package either.  A ``sitecustomize`` on the subprocesses' path makes
every one of those imports (``pointcloud_rl_tpu`` included) fail, in the process
and in every process it starts (the env workers included); then every
``pointcloud_rl_torch`` module is imported and the slices' CLI takes a few
CPU steps with two env worker processes: SAC on a host replay, DrQ on
a ``DeviceReplayMemory`` with packed bf16 storage and the bf16 agent flag,
and DrQ with the voxel encoder.
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
    # every module of the package was imported (60 with the voxel, CNN and
    # VN encoders and their ops)
    assert int(out.stdout.split()[-1]) >= 60


_FUSED = "agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.fused=True"
SLICES = {
    "sac": (SLICE_CONFIG, TINY_CLI + [_FUSED], "sac"),
    "drq_device_replay_bf16": (DRQ_CONFIG, TINY_CLI + [_FUSED, "replay_cfg.type=DeviceReplayMemory",
                                                       "replay_cfg.transfer_cfg.pack_features=True",
                                                       "agent_cfg.bf16=True"], "drq"),
    "drq_voxel": (VOXEL_CONFIG, VOXEL_TINY_CLI, "drq"),
}


@pytest.mark.parametrize("name", sorted(SLICES))
def test_slice_trains_without_jax(name, tmp_path):
    config, extra, prefix = SLICES[name]
    wd = tmp_path / "wd"
    cmd = [sys.executable, "-m", "pointcloud_rl_torch.apis.run_rl", config,
           "--work-dir", str(wd), "--seed", "0", "--device", "cpu", "--cfg-options", *extra, "replay_cfg.capacity=500",
           "train_cfg.total_steps=48", "train_cfg.warm_steps=32", "train_cfg.n_log=16",
           "train_cfg.exp_logger_cfg.type=csv", "rollout_cfg.num_procs=2", "eval_cfg.num_procs=1"]
    out = subprocess.run(cmd, env=_env(tmp_path), cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert osp.isfile(wd / "0" / "models" / "model_final")
    assert f"{prefix}/critic_loss" in (wd / "0" / "logs" / "metrics.csv").read_text().splitlines()[0]
    summary = json.loads((wd / "0" / "run_summary.json").read_text())
    assert summary["pointcloud_rl_tpu_modules"] == []
