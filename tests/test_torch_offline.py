"""The port's offline path and replay persistence in the training loop,
against the JAX package's.

- Offline training (``n_steps=0``, no rollout) from one HDF5 file, fully
  loaded or streamed in chunks (dynamic loading): the port's SAC from
  parameters carried over by ``convert.params_from_jax``, the Gaussian
  noise pinned to zero on both sides (as ``tests/test_torch_sac.py`` does),
  against the JAX loop on the same file, replay seed and batches.  The
  tolerance is the SAC parity one of ``tests/test_torch_sac.py``: every
  parameter element within Adam's envelope of ``2 * lr * updates`` and
  more than 90% of elements within 1e-4.
- ``expert_replay`` and ``recent_traj_replay`` in the loop, against the
  JAX loop on the same env with a fixed policy.
- Warm restore through the CLI: a run writes ``replay_latest.h5`` at its
  checkpoint (``train_cfg.save_replay``), ``--auto-resume`` restores it
  (log line, ``run_summary.json``) and the replay equals the file; two gloo
  ranks that resume the same work dir hold bitwise-equal replicas, equal
  to the 1-rank restore; and the walker recipe, ``pn_walker_tpu.py`` with
  its own ``save_replay=50000``, does the same at test size (skips without
  dm_control).
"""

import json
import logging
import os
import os.path as osp
import shutil
import subprocess
import sys
import textwrap

import h5py
import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, osp.dirname(__file__))

from test_torch_models import DRQ_CONFIG, TINY_CLI, jax_leaf, slice_obs, slice_setup  # noqa: E402
from test_torch_parallel import _free_port, _wait  # noqa: E402
from test_torch_replay_io import _assert_bitwise, _StubAgent, _train_offline  # noqa: E402
from test_torch_sac import LR, _pin_noise  # noqa: E402

from pointcloud_rl_torch.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
WALKER_CONFIG = osp.join(REPO, "configs/mfrl/sac/dm_control/pn_walker_tpu.py")
K_UPDATES = 4


def _slice_file(path, n, seed=0):
    """``n`` tiny-slice transitions (64 points, 8 actions), written by the
    port's host replay."""
    from pointcloud_rl_torch.env.replay import ReplayMemory

    rs = np.random.RandomState(seed)
    mem = ReplayMemory(n)
    mem.push_batch(dict(obs=slice_obs(seed, n), next_obs=slice_obs(seed + 1, n),
                        actions=np.clip(rs.randn(n, 8), -0.99, 0.99).astype(np.float32),
                        rewards=rs.randn(n, 1).astype(np.float32), dones=rs.rand(n, 1) < 0.2,
                        episode_dones=np.zeros((n, 1), bool)))
    mem.to_hdf5(str(path))
    return str(path)


@pytest.mark.parametrize("capacity", [64, 24], ids=["full_load", "dynamic_loading"])
def test_offline_training_from_hdf5_matches_jax(capacity, monkeypatch, tmp_path):
    from pointcloud_rl_torch.algorithms import build_agent as t_build_agent
    from pointcloud_rl_torch.apis.train_rl import train_rl as t_train_rl
    from pointcloud_rl_torch.env.replay import ReplayMemory as T
    from pointcloud_rl_tpu.algorithms import build_agent as j_build_agent
    from pointcloud_rl_tpu.apis.train_rl import train_rl as j_train_rl
    from pointcloud_rl_tpu.env.replay import ReplayMemory as J

    _pin_noise(monkeypatch)
    data = _slice_file(tmp_path / "demo.h5", 48)
    agent_cfg, env_info, _ = slice_setup(fused=True)
    j_agent = j_build_agent(dict(agent_cfg, env_params=env_info, seed=0))
    t_agent = t_build_agent(dict(agent_cfg, env_params=env_info, seed=0, device="cpu"))
    st = j_agent.train_state
    t_agent.load_params(params_from_jax(st.params, st.target_params, st.log_alpha))
    replays = {}
    for side, cls, loop, agent in (("torch", T, t_train_rl, t_agent), ("jax", J, j_train_rl, j_agent)):
        replays[side] = mem = cls(capacity=capacity, buffer_filenames=[data], seed=1)
        try:
            loop(agent, None, None, mem, work_dir=str(tmp_path / side), total_steps=K_UPDATES, warm_steps=0,
                 n_steps=0, n_updates=1, n_log=2, n_eval=-1, n_checkpoint=-1)
        finally:
            mem.close()
    assert replays["torch"].dynamic_loading == replays["jax"].dynamic_loading == (capacity < 48)
    assert replays["torch"]._chunk_sampled == replays["jax"]._chunk_sampled
    assert t_agent.updates == int(j_agent.train_state.updates) == K_UPDATES
    assert osp.isfile(tmp_path / "torch" / "models" / "model_final")

    envelope = 2 * LR * K_UPDATES * 1.01
    params = jax.device_get(j_agent.train_state.params)
    for name, value in t_agent.model.state_dict().items():
        diff = np.abs(value.numpy() - jax_leaf(params, name))
        assert diff.max() < envelope, f"{name}: max diff {diff.max()} outside the Adam envelope"
        assert (diff < 1e-4).mean() > 0.9, f"{name}: only {(diff < 1e-4).mean():.2%} of elements tight"
    np.testing.assert_allclose(float(t_agent.log_alpha.detach()), float(j_agent.train_state.log_alpha), atol=1e-5)


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.fixture
def pcrl_log():
    """The messages of the "pcrl" logger (both packages log there)."""
    handler = _Messages()
    logger = logging.getLogger("pcrl")
    logger.addHandler(handler)
    yield handler.lines
    logger.removeHandler(handler)


@pytest.mark.parametrize("capacity", [100, 16], ids=["full_load", "dynamic_loading"])
def test_expert_replay_attaches_like_the_original(capacity, pcrl_log, tmp_path):
    from pointcloud_rl_torch.env.replay import ReplayMemory as T
    from pointcloud_rl_tpu.env.replay import ReplayMemory as J
    from test_torch_replay_io import _trajectory_file

    fn = _trajectory_file(tmp_path / "expert.h5", 3, 10, 0)
    for side, cls in (("torch", T), ("jax", J)):
        expert = cls(capacity=capacity, buffer_filenames=[fn], seed=0)
        mem = cls(capacity=64, buffer_filenames=[fn], seed=0)
        try:
            agent = _train_offline(side, mem, tmp_path / side, save_replay=0, total=2, n_checkpoint=-1,
                                   expert_replay=expert)
        finally:
            expert.close()
        assert agent.expert_replay is expert
        assert len(expert) == min(capacity, 30) and expert.dynamic_loading == (capacity < 30)
    attached = [line for line in pcrl_log if line.startswith("Expert replay attached")]
    want = f"Expert replay attached: {min(capacity, 30)} transitions" + (" (dynamic)" if capacity < 30 else "")
    assert attached == [want, want]


class _FixedPolicy:
    """A policy that acts with a constant action; the rest is what
    ``train_rl`` calls on an agent."""

    def __init__(self, side):
        self.stub = _StubAgent(side == "torch")
        self.data_parallel = getattr(self.stub, "data_parallel", None)

    def __call__(self, obs, mode="explore"):
        return np.full((len(obs), 3), 0.3, np.float32)

    def __getattr__(self, name):
        return getattr(self.stub, name)


def _recent_counts(side, tmp_path):
    """The recent-trajectory replay's length at each log boundary (just
    before the loop empties it), and the env steps of the loop."""
    if side == "torch":
        from pointcloud_rl_torch.apis.train_rl import train_rl
        from pointcloud_rl_torch.env.replay import ReplayMemory
        from pointcloud_rl_torch.env.rollout import Rollout
        extra = dict(device="cpu")
    else:
        from pointcloud_rl_tpu.apis.train_rl import train_rl
        from pointcloud_rl_tpu.env import ReplayMemory, Rollout
        extra = {}
    # one env in this process: no worker is forked from a process that runs JAX
    rollout = Rollout(env_cfg=dict(type="gym", env_name="reacher3d_easy-v0", obs_mode="state"), num_procs=1,
                      base_seed=0, **extra)
    recent = ReplayMemory(capacity=100)
    counts, rewards = [], []
    reset = recent.reset

    def counting_reset():
        counts.append(len(recent))
        rewards.append(recent.get_all()["rewards"].copy() if len(recent) else None)
        reset()

    recent.reset = counting_reset
    try:
        train_rl(_FixedPolicy(side), rollout, None, ReplayMemory(capacity=200), work_dir=str(tmp_path / side),
                 total_steps=40, warm_steps=8, n_steps=4, n_updates=1, n_log=12, n_eval=-1, n_checkpoint=-1,
                 recent_traj_replay=recent)
    finally:
        rollout.close()
    return counts, rewards, len(recent)


def test_recent_traj_replay_gets_every_transition_like_the_original(tmp_path):
    """The recent-trajectory replay receives each collection's transitions
    (not the warm-up's) and is emptied at each log boundary, with the same
    counts and contents as the JAX loop on the same env and policy."""
    t_counts, t_rewards, t_left = _recent_counts("torch", tmp_path)
    j_counts, j_rewards, j_left = _recent_counts("jax", tmp_path)
    # warm-up 8, then cycles of 4 env steps; log boundaries at 12, 24, 36
    assert t_counts == j_counts == [4, 12, 12]
    assert t_left == j_left == 4
    for a, b in zip(t_rewards, j_rewards):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ the CLI resume
_RESTORE_CLI = TINY_CLI + [
    "agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.fused=True", "replay_cfg.type=DeviceReplayMemory",
    "replay_cfg.transfer_cfg.pack_features=True", "agent_cfg.bf16=True", "replay_cfg.capacity=500",
    "train_cfg.warm_steps=16", "train_cfg.n_log=16", "train_cfg.n_checkpoint=32", "train_cfg.save_replay=24",
    "train_cfg.exp_logger_cfg.type=csv", "rollout_cfg.num_procs=1", "eval_cfg.num_procs=1",
]


def _file_tree(path):
    from pointcloud_rl_torch.env.replay import h5_read

    with h5py.File(path, "r") as f:
        def walk(g):
            return {k: walk(v) if hasattr(v, "items") else h5_read(v) for k, v in g.items()}
        return walk(f)


def _ring(replay):
    """The restored transitions of a ``DeviceReplayMemory`` (at position 0,
    in push order) as CPU tensors."""
    from pointcloud_rl_torch.utils.tree_ops import tree_map

    return tree_map(lambda s: s[:len(replay)].cpu(), replay.storage)


@pytest.fixture(scope="module")
def snapshot_run(tmp_path_factory):
    """A DrQ run of 48 env steps on a packed bf16 device replay (CPU) with a
    checkpoint at 32 and ``save_replay=24``: its work dir."""
    from pointcloud_rl_torch.apis import run_rl

    wd = tmp_path_factory.mktemp("snap") / "wd"
    run_rl.main([DRQ_CONFIG, "--work-dir", str(wd), "--seed", "0", "--device", "cpu", "--cfg-options",
                 *_RESTORE_CLI, "train_cfg.total_steps=48"])
    return wd


def test_auto_resume_restores_the_snapshot(snapshot_run, monkeypatch, pcrl_log, tmp_path):
    from pointcloud_rl_torch.apis import run_rl

    wd = tmp_path / "wd"
    shutil.copytree(snapshot_run, wd)
    models = wd / "0" / "models"
    assert sorted(os.listdir(models)) == ["model_32", "model_final", "replay_latest.h5"]
    snap = _file_tree(models / "replay_latest.h5")
    assert len(snap["rewards"]) == 24 and snap["obs"]["pcd"].dtype == torch.bfloat16
    seen = {}
    real = run_rl.train_rl

    def spy(**kw):
        seen["ring"] = _ring(kw["replay"])
        return real(**kw)

    monkeypatch.setattr(run_rl, "train_rl", spy)
    run_rl.main([DRQ_CONFIG, "--work-dir", str(wd), "--seed", "0", "--device", "cpu", "--auto-resume",
                 "--cfg-options", *_RESTORE_CLI, "train_cfg.total_steps=64"])
    _assert_bitwise(seen["ring"], snap)
    assert "Restored replay snapshot: 24 transitions" in pcrl_log
    assert not any(line.startswith("Warm-up finished") for line in pcrl_log)  # a warm buffer skips it
    summary = json.loads((wd / "0" / "run_summary.json").read_text())
    assert summary["resume_steps"] == 32 and summary["replay_restored"] == 24 and summary["steps"] == 64
    assert summary["replay"]["size"] == 24 + 32  # then 8 cycles of 4 env steps


_RESTORE_RANK = textwrap.dedent("""
    import os, sys
    import torch
    from pointcloud_rl_torch.apis import run_rl
    from pointcloud_rl_torch.utils.tree_ops import tree_map

    def main(config, work_dir, out, world, *opts):
        args = run_rl.parse_args([config, "--work-dir", work_dir, "--seed", "0", "--device", "cpu",
                                  "--auto-resume", "--cfg-options", *opts])
        cfg = run_rl.load_config(args.config, args.cfg_options)
        seed = run_rl.set_host_seed(args.seed)
        work_dir = run_rl.build_work_dir(cfg, args.config, args.work_dir, args.seed)

        def spy(**kw):  # the replica as the loop receives it, then no training
            replay = kw["replay"]
            torch.save(tree_map(lambda s: s[:len(replay)].clone(), replay.storage),
                       out % os.environ.get("RANK", "solo"))
            return {"steps": kw["resume_steps"], "grad_steps": 0, "main_loop_s": 1.0, "main_loop_env_steps": 0}

        run_rl.train_rl = spy
        run_rl.run(cfg, work_dir, seed, args, world=int(world))

    if __name__ == "__main__":
        main(*sys.argv[1:])
""")


def test_ranks_restore_bitwise_equal_replicas(snapshot_run, tmp_path):
    """Two gloo ranks resuming the same work dir each read the snapshot into
    their replica: bitwise equal to each other and to the 1-rank restore."""
    wd, wd_solo = tmp_path / "wd", tmp_path / "wd_solo"  # one copy per world: each lead writes its own files
    shutil.copytree(snapshot_run, wd)
    shutil.copytree(snapshot_run, wd_solo)
    script = tmp_path / "restore_rank.py"
    script.write_text(_RESTORE_RANK)
    out = str(tmp_path / "replica_%s.pt")
    opts = [*_RESTORE_CLI, "train_cfg.total_steps=64"]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(script), DRQ_CONFIG, str(wd), out, "2", *opts], cwd=REPO,
                              text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env=dict(env, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                                       RANK=str(rank)))
             for rank in range(2)]
    procs.append(subprocess.Popen([sys.executable, str(script), DRQ_CONFIG, str(wd_solo), out, "1", *opts],
                                  cwd=REPO, text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env))
    for rc, log in _wait(procs):
        assert rc == 0, log[-4000:]
    replicas = {r: torch.load(out % r) for r in ("0", "1", "solo")}
    assert replicas["solo"]["rewards"].shape[0] == 24
    _assert_bitwise(replicas["0"], replicas["solo"])
    _assert_bitwise(replicas["1"], replicas["solo"])
    _assert_bitwise(replicas["solo"], _file_tree(wd_solo / "0" / "models" / "replay_latest.h5"))
    for d in (wd, wd_solo):  # each world's lead
        assert json.loads((d / "0" / "run_summary.json").read_text())["replay_restored"] == 24


# ---------------------------------------------------------- the walker recipe
def _dmc_available():
    try:
        from dm_control import suite  # noqa: F401

        return True
    except Exception:
        return False


_WALKER_TINY = [
    "env_cfg.n_points=48", "env_cfg.num_ground=16", "env_cfg.image_size=[32,32]",
    "agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.mlp_spec=[16,16,32]",
    "agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.out_channels=16",
    "agent_cfg.actor_cfg.nn_cfg.mlp_cfg.mlp_spec=[16,32,32,'action_shape * 2']",
    "agent_cfg.critic_cfg.nn_cfg.mlp_cfg.mlp_spec=['16 + action_shape',32,32,1]",
    "agent_cfg.batch_size=16", "replay_cfg.capacity=500", "rollout_cfg.num_procs=2",
    "train_cfg.warm_steps=16", "train_cfg.n_log=16", "train_cfg.n_checkpoint=32",
    "train_cfg.exp_logger_cfg.type=csv", "eval_cfg.save_video=False",
]

_WALKER_RESUME = textwrap.dedent("""
    import json, sys
    import torch
    from pointcloud_rl_torch.apis import run_rl

    def main(out, *argv):
        real = run_rl.train_rl

        def spy(**kw):  # the restored ring as the loop receives it
            replay = kw["replay"]
            torch.save({"len": len(replay), "position": replay.position,
                        "pcd": replay.storage["obs"]["pcd"][:len(replay)].clone(),
                        "next_pcd": replay.storage["next_obs"]["pcd"][:len(replay)].clone(),
                        "rewards": replay.storage["rewards"][:len(replay)].clone()}, out)
            return real(**kw)

        run_rl.train_rl = spy
        run_rl.main(list(argv))

    if __name__ == "__main__":
        main(*sys.argv[1:])
""")


@pytest.mark.dmc
@pytest.mark.skipif(not _dmc_available(), reason="dm_control unavailable")
def test_walker_recipe_snapshots_and_resumes_warm(tmp_path):
    """``pn_walker_tpu.py`` with its ``save_replay=50000`` trains at test
    size through ``run_rl --device cpu``, writes the snapshot at its
    checkpoint, and ``--auto-resume`` restores it: the ring equals the
    file, the log and ``run_summary.json`` say so, and the warm-up is
    skipped."""
    from pointcloud_rl_torch.config import Config

    assert Config.fromfile(WALKER_CONFIG)["train_cfg"]["save_replay"] == 50000
    wd = tmp_path / "wd"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    base = [WALKER_CONFIG, "--work-dir", str(wd), "--seed", "0", "--device", "cpu"]
    first = subprocess.run([sys.executable, "-m", "pointcloud_rl_torch.apis.run_rl", *base, "--cfg-options",
                            *_WALKER_TINY, "train_cfg.total_steps=48"],
                           cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert first.returncode == 0, first.stderr[-3000:]
    snap_path = wd / "0" / "models" / "replay_latest.h5"
    assert "Saved replay snapshot (32 transitions)" in first.stderr
    snap = _file_tree(snap_path)
    assert set(snap["obs"]) == {"pcd"} and snap["obs"]["pcd"].dtype == torch.bfloat16 and len(snap["rewards"]) == 32

    script = tmp_path / "resume.py"
    script.write_text(_WALKER_RESUME)
    ring_path = str(tmp_path / "ring.pt")
    second = subprocess.run([sys.executable, str(script), ring_path, *base, "--auto-resume", "--cfg-options",
                             *_WALKER_TINY, "train_cfg.total_steps=64"],
                            cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert second.returncode == 0, second.stderr[-3000:]
    assert "Restored replay snapshot: 32 transitions" in second.stderr
    assert "Warm-up finished" not in second.stderr
    ring = torch.load(ring_path)
    assert ring["len"] == 32 and ring["position"] == 32
    _assert_bitwise(ring["pcd"], snap["obs"]["pcd"])
    _assert_bitwise(ring["next_pcd"], snap["next_obs"]["pcd"])
    _assert_bitwise(ring["rewards"], snap["rewards"])
    summary = json.loads((wd / "0" / "run_summary.json").read_text())
    assert summary["resume_steps"] == 32 and summary["replay_restored"] == 32 and summary["steps"] == 64
    assert summary["pointcloud_rl_tpu_modules"] == []
