"""The port's training across hosts on the CPU (gloo ranks).

- ``run_rl`` started by ``torch.distributed.run`` on two "hosts" of this
  machine (``--nnodes 2``), one rank per host and two: it trains, every
  rank's parameters are bitwise equal, the hosts' replays are bitwise equal
  (each host collects with the same seeds, as the JAX package's hosts do:
  ROADMAP C9), rank 0 alone writes, and ``run_summary.json`` gives the
  hosts; a SIGTERM to host 1's rank stops both at one step, with the
  preemption checkpoint (``tests/_torch_multihost_worker.py run``).
- The rank-local batch against JAX: two hosts fed different pushes, the
  noise pinned to zero; the 2-rank update equals the JAX package's
  single-device update on the rows each host contributes, concatenated in
  rank order, which is what the JAX package's mesh across hosts computes
  (``_torch_multihost_worker.py hosts``).
- The straggler vote of the full-episode rollout against the JAX
  package's, in one process with the host count and the ``DistVar``
  scripted: the same pushes, the partial episodes flushed alike.
- The episode statistics over hosts against the JAX package's
  ``allreduce_stats``, and, where one host has an info key the other lacks
  (ROADMAP C10), the mean of each key over the hosts that report it.
"""

import csv
import glob
import json
import os
import os.path as osp
import signal
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, osp.dirname(__file__))

from test_torch_models import SLICE_CONFIG, jax_leaf, slice_setup  # noqa: E402
from test_torch_parallel import _OPTS, PARAM_TOL  # noqa: E402
from test_torch_sac import METRIC_RTOL, _pin_noise  # noqa: E402

from pointcloud_rl_torch.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
WORKER = osp.join(osp.dirname(__file__), "_torch_multihost_worker.py")
TIMEOUT_S = 240  # per spawned process (pytest-timeout is not installed)
BATCH_KEYS = ("obs", "next_obs", "actions", "rewards", "dones", "episode_dones")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait(procs, timeout=TIMEOUT_S):
    """Every process's (return code, output); all are killed on a timeout."""
    out = []
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a spawned process timed out")
        out.append((p.returncode, stdout))
    return out


def _torchrun(out_dir, ranks_per_host, opts):
    """Two ``torch.distributed.run`` agents, one per host, each starting
    ``ranks_per_host`` ranks of ``run_rl`` on the tiny SAC slice."""
    port = str(_free_port())
    env = dict(os.environ, PCRL_MH_OUT=str(out_dir), OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--nnodes", "2", "--node-rank",
                              str(host), "--nproc-per-node", str(ranks_per_host), "--master-addr", "127.0.0.1",
                              "--master-port", port, WORKER, "run", SLICE_CONFIG, "--work-dir",
                              str(out_dir / "wd"), "--seed", "0", "--device", "cpu", "--cfg-options", *_OPTS, *opts],
                             cwd=REPO, env=env, text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for host in (0, 1)]


def _ranks(out_dir):
    return {int(osp.basename(p)[4:-3]): torch.load(p, weights_only=False)
            for p in glob.glob(str(out_dir / "rank*.pt"))}


def _assert_tree_equal(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


def _summary(out_dir):
    with open(out_dir / "wd" / "0" / "run_summary.json") as f:
        return json.load(f)


@pytest.mark.parametrize("ranks_per_host", [1, 2], ids=["2x1", "2x2"])
def test_run_rl_across_hosts(tmp_path, ranks_per_host):
    """Each host collects alike, every rank ends with the same parameters,
    and rank 0 alone writes."""
    world = 2 * ranks_per_host
    for rc, log in _wait(_torchrun(tmp_path, ranks_per_host, ["train_cfg.total_steps=96",
                                                               "train_cfg.n_checkpoint=64"])):
        assert rc == 0, log[-4000:]
    ranks = _ranks(tmp_path)
    assert sorted(ranks) == list(range(world))
    assert [(r["host"], r["host_lead"]) for _, r in sorted(ranks.items())] == \
        [(h, i == 0) for h in (0, 1) for i in range(ranks_per_host)]
    for rank, res in ranks.items():
        assert res["steps"] == 96
        for part in ("model", "target", "log_alpha"):
            _assert_tree_equal(res[part], ranks[0][part], f"rank {rank} {part}")
        _assert_tree_equal(res["replay"], ranks[0]["replay"], f"rank {rank} replay")  # C9: the hosts' too
    assert len(ranks[0]["replay"]["rewards"]) == 96
    out = _summary(tmp_path)
    assert out["world_size"] == world and out["hosts"] == 2 and out["ranks_per_host"] == [ranks_per_host] * 2
    assert out["collected_steps_per_host"] == [96, 96] and out["steps"] == 96 and out["grad_steps"] == 16
    assert out["pointcloud_rl_tpu_modules"] == []
    run = tmp_path / "wd" / "0"
    assert sorted(os.listdir(run / "models")) == ["model_64", "model_final"]
    # one writer: one train log, one config dump, one row per log boundary
    assert len([f for f in os.listdir(run) if f.endswith("-train.log")]) == 1
    assert len([f for f in os.listdir(run) if f.endswith("-config.py")]) == 1
    with open(run / "logs" / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert [row["step"] for row in rows if row.get("train/sac/critic_loss")] == ["64", "96"]
    assert all(row["train/env/rewards_mean"] for row in rows if row.get("train/sac/critic_loss"))


def test_sigterm_to_one_rank_stops_every_host(tmp_path):
    procs = _torchrun(tmp_path, 1, ["train_cfg.total_steps=100000", "train_cfg.n_checkpoint=-1"])
    metrics = tmp_path / "wd" / "0" / "logs" / "metrics.csv"
    deadline = time.monotonic() + TIMEOUT_S
    while not (metrics.exists() and metrics.read_text().count("\n") >= 2 and (tmp_path / "pid1").exists()):
        assert all(p.poll() is None for p in procs) and time.monotonic() < deadline, "the run never trained"
        time.sleep(0.2)
    os.kill(int((tmp_path / "pid1").read_text()), signal.SIGTERM)  # host 1's rank
    for rc, log in _wait(procs):
        assert rc == 0, log[-4000:]
    ranks = _ranks(tmp_path)
    steps = {r["steps"] for r in ranks.values()}
    assert len(ranks) == 2 and len(steps) == 1, steps
    step, = steps
    assert 0 < step < 100000
    assert sorted(os.listdir(tmp_path / "wd" / "0" / "models")) == [f"model_{step}", "model_final"]
    assert _summary(tmp_path)["steps"] == step


# -------------------------------------------------- two hosts, one process each
@pytest.fixture(scope="module")
def hosts(tmp_path_factory):
    """The worker's ``hosts`` results of both hosts, and the JAX agent the
    parameters came from."""
    from pointcloud_rl_tpu.algorithms import build_agent as j_build_agent

    tmp = tmp_path_factory.mktemp("hosts")
    agent_cfg, env_info, _ = slice_setup(fused=True)
    j_agent = j_build_agent(dict(agent_cfg, env_params=env_info, seed=0))
    st = j_agent.train_state
    torch.save(params_from_jax(st.params, st.target_params, st.log_alpha), tmp / "init.pt")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, WORKER, "hosts"], cwd=REPO, text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT,
                              env=dict(os.environ, PCRL_MH_OUT=str(tmp), PCRL_MH_INIT=str(tmp / "init.pt"),
                                       OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                                       WORLD_SIZE="2", RANK=str(host), GROUP_RANK=str(host), LOCAL_RANK="0",
                                       LOCAL_WORLD_SIZE="1"))
             for host in (0, 1)]
    for rc, log in _wait(procs):
        assert rc == 0, log[-4000:]
    results = [torch.load(tmp / f"hosts{host}.pt", weights_only=False) for host in (0, 1)]
    return results, j_agent


class _Batches:
    """``sample`` returns the given batches in turn."""

    def __init__(self, batches):
        self.batches = list(batches)

    def __len__(self):
        return 1000

    def sample(self, batch_size):
        return self.batches.pop(0)


def _rows(tree, lo, hi):
    return {k: _rows(v, lo, hi) for k, v in tree.items()} if isinstance(tree, dict) else tree[lo:hi]


def _concat(a, b):
    return {k: _concat(a[k], b[k]) for k in a} if isinstance(a, dict) else np.concatenate([a, b])


def test_hosts_layout(hosts):
    results, _ = hosts
    assert [(r["hosts"], r["host"], r["host_lead"]) for r in results] == [([[0], [1]], h, True) for h in (0, 1)]


def test_rank_local_batch_matches_jax(hosts, monkeypatch):
    """Rank r of two keeps rows [r*B/2, (r+1)*B/2) of the batch of its own
    host's replay: the 2-rank update is the JAX package's single-device
    update on host 0's first half and host 1's second half."""
    _pin_noise(monkeypatch)
    results, j_agent = hosts
    (h0, h1) = (r["local_batch"] for r in results)
    half = len(h0["samples"][0]["rewards"]) // 2
    for u, (a, b) in enumerate(zip(h0["samples"], h1["samples"])):
        assert not np.array_equal(a["rewards"], b["rewards"]), f"update {u}: the hosts' replays should differ"
    batches = [_concat(_rows({k: a[k] for k in BATCH_KEYS}, 0, half), _rows({k: b[k] for k in BATCH_KEYS}, half, None))
               for a, b in zip(h0["samples"], h1["samples"])]
    memory = _Batches(batches)
    j_metrics = [j_agent.update_parameters(memory, updates=u) for u in range(len(batches))]
    for part in ("model", "target", "log_alpha"):
        _assert_tree_equal(h0[part], h1[part], part)
    assert h0["metrics"] == h1["metrics"]
    for u, (a, b) in enumerate(zip(j_metrics, h0["metrics"])):
        for key in ("critic_loss", "q", "q_target", "alpha", "actor_loss", "entropy"):
            if f"sac/{key}" in a:
                x, y = a[f"sac/{key}"], b[f"sac/{key}"]
                assert abs(x - y) < METRIC_RTOL * (1 + abs(x)), f"update {u} {key}: jax {x} vs torch {y}"
    st = j_agent.train_state
    params, target = jax.device_get(st.params), jax.device_get(st.target_params)
    for name, value in h0["model"].items():
        np.testing.assert_allclose(value.numpy(), jax_leaf(params, name), **PARAM_TOL, err_msg=name)
    for name, value in h0["target"].items():
        np.testing.assert_allclose(value.numpy(), jax_leaf(target, name), **PARAM_TOL, err_msg=name)
    np.testing.assert_allclose(float(h0["log_alpha"]), float(st.log_alpha), **PARAM_TOL)


def _jax_mean(reports, monkeypatch):
    """The JAX package's ``allreduce_stats(op="mean")`` on host 0 with the
    hosts' ``reports`` as its all-gather."""
    from jax.experimental import multihost_utils

    from pointcloud_rl_tpu.parallel import allreduce_stats

    monkeypatch.setattr(jax, "process_count", lambda: len(reports))
    monkeypatch.setattr(multihost_utils, "process_allgather",
                        lambda local: np.stack([np.asarray([r[k] for k in sorted(r)], np.float64) for r in reports]))
    return allreduce_stats(reports[0], op="mean")


def test_episode_stats_over_hosts_match_jax(hosts, monkeypatch):
    results, _ = hosts
    local = [r["episode_stats"]["same_keys"]["local"] for r in results]
    assert local[0] != local[1] and local[0].keys() == local[1].keys()
    want = _jax_mean(local, monkeypatch)
    for r in results:
        got = r["episode_stats"]["same_keys"]["reduced"]
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k] == pytest.approx(float(v), rel=1e-15, abs=0), k


def test_episode_stats_with_a_key_one_host_lacks(hosts, monkeypatch):
    """C10: host 1 reports ``grasp``, host 0 does not.  The JAX package's
    reduction stacks vectors of different lengths (an all-gather that fails
    or hangs across hosts); the port averages each key over the hosts that
    report it, and keeps every key."""
    results, _ = hosts
    h0, h1 = (r["episode_stats"]["extra_key"]["local"] for r in results)
    extra = set(h1) - set(h0)
    assert extra == {"env/grasp_mean", "env/grasp_min", "env/grasp_max"} and set(h0) < set(h1)
    with pytest.raises(ValueError):
        _jax_mean([h0, h1], monkeypatch)
    for r in results:
        got = r["episode_stats"]["extra_key"]["reduced"]
        assert set(got) == set(h1)
        for k in h0:
            assert got[k] == pytest.approx((h0[k] + h1[k]) / 2, rel=1e-15, abs=0), k
        for k in extra:
            assert got[k] == h1[k]


# ------------------------------------------------------- the straggler vote
class _ScriptedVote:
    """Stands in for ``DistVar("rollout_num_done")``: ``get`` answers 0
    for its first ``after`` calls and 1 (the other host is done) after."""

    after = 0
    made: list = []

    def __init__(self, name):
        assert name == "rollout_num_done"
        self.gets, self.adds = 0, 0
        _ScriptedVote.made.append(self)

    def get(self):
        self.gets += 1
        return int(self.gets > self.after)

    def add(self, value=1):
        self.adds += value


VOTE_NUM = 42  # 2 envs, episodes of 9 steps: full episodes reach 36 after 18 steps, past 0.8 * 42 (not 0.9 * 42)


@pytest.mark.parametrize("after", [1, 10**9], ids=["fires", "never"])
def test_straggler_vote_matches_jax(after, monkeypatch):
    from pointcloud_rl_torch.env import build_replay as t_build_replay
    from pointcloud_rl_torch.env.rollout import Rollout as TRollout
    from pointcloud_rl_torch.parallel import distributed as t_dist
    from pointcloud_rl_tpu import parallel as j_parallel
    from pointcloud_rl_tpu.env import build_replay as j_build_replay
    from pointcloud_rl_tpu.env.rollout import Rollout as JRollout

    _, _, env_cfg = slice_setup(fused=True)
    env_cfg = dict(env_cfg, horizon=9)
    monkeypatch.setattr(_ScriptedVote, "after", after)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(j_parallel, "DistVar", _ScriptedVote)
    monkeypatch.setattr(t_dist, "DistVar", _ScriptedVote)
    monkeypatch.setattr(t_dist, "num_hosts", lambda: 2)

    def pi(obs, mode="explore"):
        return np.full((2, 8), 0.3, np.float32)

    outs = []
    for rollout_cls, build_replay, extra in ((JRollout, j_build_replay, {}), (TRollout, t_build_replay,
                                                                              {"device": "cpu"})):
        _ScriptedVote.made = []
        rollout = rollout_cls(env_cfg, num_procs=2, full_episode=True, base_seed=0, vec_backend="thread", **extra)
        replay = build_replay(dict(type="ReplayMemory", capacity=100), dict(seed=0))
        try:
            rollout.forward_with_policy(pi, VOTE_NUM, replay)
        finally:
            rollout.close()
        vote, = _ScriptedVote.made
        outs.append((replay, (vote.gets, vote.adds)))
    (j_replay, j_vote), (t_replay, t_vote) = outs
    assert j_vote == t_vote and t_vote[1] == 1
    assert len(t_replay) == len(j_replay)
    if after == 1:  # cut after one step past 36: each worker's 1-step partial flushed
        assert len(t_replay) == 38 and t_vote[0] == 2
    else:
        assert len(t_replay) == VOTE_NUM
    n = len(t_replay)
    for key in ("actions", "rewards", "dones", "episode_dones", "worker_indices"):
        np.testing.assert_array_equal(t_replay.memory[key][:n], j_replay.memory[key][:n], err_msg=key)
    for key in j_replay.memory["obs"]:
        np.testing.assert_array_equal(t_replay.memory["obs"][key][:n], j_replay.memory["obs"][key][:n], err_msg=key)
    assert {w: len(v) for w, v in t_replay._traj_cache.items()} == {w: len(v) for w, v in j_replay._traj_cache.items()}
