"""The pipelined collection path of the port against the JAX package's.

(i) ``BaseAgent.forward_async``: the handle's semantics, and its actions
equal ``forward``'s (and, in eval mode, the JAX agent's) for SAC, DrQ,
DDPG and a recurrent SAC.  (ii) Both packages' copied ``Rollout`` on
FakeManipulation with 4 envs, ``pipeline_groups`` 1 and 2 and
``action_lag`` 0 and 1, with one policy carried across by ``convert`` and
called in eval mode, so no draw differs: the pushed transitions are equal,
per env worker (and in push order with one group), and with
``action_lag=1`` the action applied at each step is the policy on the
previous step's obs.  (iii) The interleaved updates: a recording stub
agent and a stub replay named ``DeviceReplayMemory`` go through both
packages' ``train_rl``, which must make the same ``update_parameters_scan``
calls, in the same order between the same act dispatches, and the same
remainder flush; in a world of 2 gloo ranks on one host (``run_rl
--num-devices 2``) each rank makes the JAX loop's scans, the ranks in
lockstep, and ends with the other's parameters.
"""

import copy
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, osp.dirname(__file__))

from test_torch_models import SLICE_CONFIG, DRQ_CONFIG, TINY_CLI, slice_obs, slice_setup  # noqa: E402
from test_torch_recurrent import RNN  # noqa: E402

from pointcloud_rl_torch.algorithms.base import ActionHandle  # noqa: E402
from pointcloud_rl_torch.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
# Actions of the two packages from the same parameters: f32 sums in another
# order through the PointNet and the heads (~1e-6); the envs' obs and
# rewards then follow those actions, so transitions agree to the same order.
JAX_ATOL = 1e-5
# The port's policy on one row against the same row in a batch of several:
# the same f32 math, reduced in another blocking at most.
ROW_ATOL = 1e-6
ENVS = 4
CALLS = 3  # collection calls of ENVS * 2 env steps each


def _agents(kind):
    """(JAX agent, port agent with the JAX agent's parameters) of the tiny
    slice: ``kind`` in sac, drq, ddpg, rnn."""
    from pointcloud_rl_torch.algorithms import build_agent as t_build_agent
    from pointcloud_rl_tpu.algorithms import build_agent as j_build_agent

    if kind == "drq":
        agent_cfg, env_info, _ = slice_setup(fused=True, config=DRQ_CONFIG)
    elif kind == "ddpg":
        agent_cfg, env_info, _ = slice_setup(fused=True, type="DDPG")
    else:
        agent_cfg, env_info, _ = slice_setup(fused=True)
        if kind == "rnn":
            agent_cfg = copy.deepcopy(agent_cfg)
            agent_cfg["actor_cfg"]["nn_cfg"]["rnn_cfg"] = dict(RNN["agent_cfg.actor_cfg.nn_cfg.rnn_cfg"])
    j_agent = j_build_agent(dict(agent_cfg, env_params=env_info, seed=0))
    t_agent = t_build_agent(dict(agent_cfg, env_params=env_info, seed=0, device="cpu"))
    st = j_agent.train_state
    t_agent.load_params(params_from_jax(st.params, st.target_params, st.log_alpha))
    return j_agent, t_agent


# --------------------------------------------------------- (i) the handle
class _Event:
    """A stand-in for ``torch.cuda.Event``: pending until ``done``."""

    def __init__(self):
        self.done = False
        self.waits = 0

    def query(self):
        return self.done

    def synchronize(self):
        self.waits += 1
        self.done = True


def test_handle_polls_without_waiting_and_waits_when_read():
    host = np.arange(6, dtype=np.float32).reshape(2, 3)
    event = _Event()
    handle = ActionHandle(host, event)
    assert not handle.is_ready() and event.waits == 0  # a poll never waits
    np.testing.assert_array_equal(np.asarray(handle), host)
    assert event.waits == 1 and handle.is_ready()
    np.testing.assert_array_equal(np.asarray(handle, np.float64), host)  # read again: no second wait
    assert event.waits == 1
    ready = ActionHandle(host)  # a CPU act: ready at once
    assert ready.is_ready() and np.asarray(ready) is host


@pytest.mark.parametrize("kind", ["sac", "drq", "ddpg", "rnn"])
def test_forward_async_equals_forward_and_jax(kind):
    j_agent, t_agent = _agents(kind)
    obs = [slice_obs(seed, 3) for seed in (5, 6)]
    if kind == "rnn":  # the state is threaded through both steps on each path
        t_agent.reset_rnn_states()
        handles = [t_agent.forward_async(o, mode="eval") for o in obs]
        t_agent.reset_rnn_states()
        want = [t_agent.forward(o, mode="eval") for o in obs]
    else:
        handles = [t_agent.forward_async(o, mode="eval") for o in obs]
        want = [t_agent.forward(o, mode="eval") for o in obs]
    assert all(h.is_ready() for h in handles)
    got = [np.asarray(h) for h in handles]  # two handles in flight hold their own actions
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got[0], got[1])
    j_agent.reset_rnn_states()
    for g, o in zip(got, obs):
        np.testing.assert_allclose(g, np.asarray(j_agent.forward_async(o, mode="eval")), atol=JAX_ATOL)
    # explore mode: the same draws from the same generator state
    if kind == "rnn":
        t_agent.reset_rnn_states()
    state = t_agent.act_generator.get_state()
    explore = np.asarray(t_agent.forward_async(obs[0], mode="explore"))
    t_agent.act_generator.set_state(state)
    if kind == "rnn":
        t_agent.reset_rnn_states()
    np.testing.assert_array_equal(explore, t_agent.forward(obs[0], mode="explore"))


# ------------------------------------------------------- (ii) the rollouts
class _EvalPolicy:
    """The agent's ``forward_async`` in eval mode, whatever mode the
    rollout asks for: the same actions from both packages, no draws."""

    def __init__(self, agent):
        self.agent = agent

    def forward_async(self, obs, mode="explore"):
        return self.agent.forward_async(obs, mode="eval")

    def __call__(self, obs, mode="explore"):
        return self.agent.forward(obs, mode="eval")


class _Recorder:
    """A replay that keeps a copy of every pushed batch."""

    def __init__(self):
        self.pushes = []

    def __len__(self):
        return sum(len(p["rewards"]) for p in self.pushes)

    def push_batch(self, batch):
        self.pushes.append(copy.deepcopy({k: v for k, v in batch.items() if k != "infos"}))


def _rows(pushes):
    """The pushed transitions as one list of rows, in push order."""
    rows = []
    for p in pushes:
        for i in range(len(p["rewards"])):
            rows.append({k: ({kk: vv[i] for kk, vv in v.items()} if isinstance(v, dict) else v[i])
                         for k, v in p.items()})
    return rows


def _collect(side, agent, groups, lag, monkeypatch):
    if side == "torch":
        from pointcloud_rl_torch.env import rollout as mod
        extra = dict(device="cpu")
    else:
        from pointcloud_rl_tpu.env import rollout as mod
        extra = {}
    pipelined = []
    original = mod.Rollout._forward_pipelined

    def spy(self, *args, **kwargs):
        pipelined.append(True)
        return original(self, *args, **kwargs)

    monkeypatch.setattr(mod.Rollout, "_forward_pipelined", spy)
    _, _, env_cfg = slice_setup()
    rollout = mod.Rollout(env_cfg=env_cfg, num_procs=ENVS, base_seed=0, vec_backend="thread",
                          pipeline_groups=groups, action_lag=lag, **extra)
    replay = _Recorder()
    try:
        assert rollout.pipeline_groups == (2 if groups is None else groups)
        for _ in range(CALLS):
            rollout.forward_with_policy(_EvalPolicy(agent), ENVS * 2, replay)
    finally:
        rollout.close()
    return _rows(replay.pushes), len(pipelined) == CALLS


def _by_worker(rows):
    out = {}
    for r in rows:
        out.setdefault(int(r["worker_indices"][0]), []).append(r)
    return out


def _assert_rows_close(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_rows_close(a[k], b[k])
        elif np.asarray(a[k]).dtype.kind == "f":
            np.testing.assert_allclose(a[k], b[k], atol=JAX_ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("groups", [1, 2, None], ids=["one_group", "two_groups", "default_groups"])
@pytest.mark.parametrize("lag", [0, 1], ids=["no_lag", "lag"])
def test_rollouts_push_the_same_transitions_as_jax(groups, lag, monkeypatch):
    j_agent, t_agent = _agents("sac")
    t_rows, t_pipelined = _collect("torch", t_agent, groups, lag, monkeypatch)
    j_rows, j_pipelined = _collect("jax", j_agent, groups, lag, monkeypatch)
    # both take the pipelined path exactly where the JAX package does
    assert t_pipelined == j_pipelined == (groups != 1 or lag == 1)
    assert len(t_rows) == len(j_rows) == CALLS * ENVS * 2
    if groups == 1:  # one group: in push order
        for a, b in zip(t_rows, j_rows):
            _assert_rows_close(a, b)
    t_workers, j_workers = _by_worker(t_rows), _by_worker(j_rows)
    assert sorted(t_workers) == sorted(j_workers) == list(range(ENVS))
    for w in t_workers:  # as multisets: each worker's chain is in its own order
        for a, b in zip(t_workers[w], j_workers[w]):
            _assert_rows_close(a, b)
        # the applied actions: the policy on this step's obs, or (lag) on the previous step's
        steps = t_workers[w]
        obs = {k: np.stack([r["obs"][k] for r in steps]) for k in steps[0]["obs"]}
        pi = t_agent.forward(obs, mode="eval")
        applied = np.stack([r["actions"] for r in steps])
        if lag:
            np.testing.assert_allclose(applied[0], pi[0], atol=ROW_ATOL)
            np.testing.assert_allclose(applied[1:], pi[:-1], atol=ROW_ATOL)
            assert not np.allclose(applied[1:], pi[1:], atol=1e-3)
        else:
            np.testing.assert_allclose(applied, pi, atol=ROW_ATOL)


# ------------------------------------------------ (iii) the interleaving
class _RecordingAgent:
    """What both ``train_rl`` loops call on an agent, recorded as events:
    ``("act", envs)`` per act dispatch, ``("scan", len(replay), n)`` per
    ``update_parameters_scan`` and ``("update", len(replay))`` per
    ``update_parameters``."""

    def __init__(self, torch_side, action_dim):
        if torch_side:
            from pointcloud_rl_torch.parallel import DataParallel

            self.data_parallel = DataParallel()
        self.device = torch.device("cpu")
        self.events = []
        self.action_dim = action_dim

    def train(self):
        return self

    def eval(self):
        return self

    def forward_async(self, obs, mode="explore"):
        n = len(obs["xyz"])
        self.events.append(("act", n))
        return ActionHandle(np.zeros((n, self.action_dim), np.float32))

    def update_parameters_scan(self, memory, n):
        self.events.append(("scan", len(memory), n))
        return np.array([float(n)])

    def update_parameters(self, memory, updates):
        self.events.append(("update", len(memory)))
        return {"x": 1.0}

    def reduce_metric_vecs(self, vec_sum, count):
        assert float(vec_sum[0]) == count
        return {"updates": float(count)}

    def state_dict(self):
        return {"w": np.zeros(2, np.float32)}


class DeviceReplayMemory:
    """A stub replay, named as the loops recognise an on-device one."""

    def __init__(self):
        self.n = 0

    def __len__(self):
        return self.n

    def push_batch(self, batch):
        self.n += len(batch["rewards"])


def _interleave_events(side, groups, lag, n_updates, tmp_path):
    if side == "torch":
        from pointcloud_rl_torch.apis.train_rl import train_rl
        from pointcloud_rl_torch.env.rollout import Rollout
        extra = dict(device="cpu")
    else:
        from pointcloud_rl_tpu.apis.train_rl import train_rl
        from pointcloud_rl_tpu.env import Rollout
        extra = {}
    _, env_info, env_cfg = slice_setup()
    agent = _RecordingAgent(side == "torch", env_info["action_shape"])
    rollout = Rollout(env_cfg=env_cfg, num_procs=ENVS, base_seed=0, vec_backend="thread",
                      pipeline_groups=groups, action_lag=lag, **extra)
    try:
        train_rl(agent, rollout, None, DeviceReplayMemory(), work_dir=str(tmp_path / side), total_steps=8 + 3 * 8,
                 warm_steps=8, n_steps=8, n_updates=n_updates, n_log=16, n_eval=-1, n_checkpoint=-1)
    finally:
        rollout.close()
    return agent.events


@pytest.mark.parametrize("groups, lag, n_updates", [(1, 0, 6), (1, 1, 16), (2, 0, 6), (2, 1, 5), (2, 0, 1)],
                         ids=["one_group_chunk3", "one_group_lag_chunk8", "two_groups_remainder2",
                              "two_groups_lag_remainder1", "one_update_no_hook"])
def test_interleave_schedule_is_the_jax_loops(groups, lag, n_updates, tmp_path):
    t_events = _interleave_events("torch", groups, lag, n_updates, tmp_path)
    j_events = _interleave_events("jax", groups, lag, n_updates, tmp_path)
    assert t_events == j_events
    events = (8 // ENVS) * groups
    chunk = max(1, n_updates // events)
    if n_updates > 1:
        scans = [e for e in t_events if e[0] == "scan"]
        hooked = min(events, n_updates // chunk)
        left = n_updates - hooked * chunk
        # each cycle: the chunks after its act dispatches, on the buffer before its push; then the rest
        want = []
        for cycle in range(3):
            before = 8 + 8 * cycle
            want += [("scan", before, chunk)] * hooked + ([("scan", before + 8, left)] if left else [])
        assert scans == want
        assert not any(e[0] == "update" for e in t_events)
    else:
        assert [e for e in t_events if e[0] != "act"] == [("update", 16 + 8 * c) for c in range(3)]


def test_two_ranks_on_a_host_interleave_as_the_jax_loop(tmp_path):
    """``run_rl --num-devices 2`` (gloo, one host) on a device replay, 4
    envs in 2 groups, 6 updates per cycle of 8 env steps: each rank runs
    the JAX loop's scans (a chunk of 1 after each of the 4 act dispatches,
    on the buffer before the cycle's push, then the remainder of 2), the
    host's other rank in lockstep with its lead, and the two ranks end with
    bitwise equal parameters."""
    wd, out_dir = tmp_path / "wd", tmp_path / "ranks"
    out_dir.mkdir()
    cmd = [sys.executable, osp.join(REPO, "tests", "_torch_spawned_ranks.py"), SLICE_CONFIG, "--work-dir", str(wd),
           "--seed", "0", "--device", "cpu", "--cfg-options", *TINY_CLI,
           "agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.fused=True", "replay_cfg.type=DeviceReplayMemory",
           "replay_cfg.capacity=200", "train_cfg.total_steps=32", "train_cfg.warm_steps=8", "train_cfg.n_steps=8",
           "train_cfg.n_updates=6", "train_cfg.n_log=16", "train_cfg.exp_logger_cfg.type=csv",
           f"rollout_cfg.num_procs={ENVS}", "rollout_cfg.pipeline_groups=2", "eval_cfg.num_procs=1",
           "--num-devices", "2"]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS="1", PCRL_RANKS_OUT=str(out_dir)))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "not interleaved" not in out.stdout + out.stderr
    assert osp.isfile(wd / "0" / "models" / "model_final")
    j_scans = [e for e in _interleave_events("jax", 2, 0, 6, tmp_path) if e[0] == "scan"]
    want = []
    for c in range(3):  # 4 chunks of 1 on the buffer before the cycle's push, then the remainder after it
        want += [("scan", 8 + 8 * c, 1)] * 4 + [("scan", 16 + 8 * c, 2)]
    assert j_scans == want
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in (0, 1)]
    for r, res in enumerate(ranks):
        assert res["scans"] == j_scans, (r, res["scans"], j_scans)
        assert res["updates"] == res["grad_steps"] == 18
    for part in ("model", "target"):
        for k, v in ranks[0][part].items():
            assert torch.equal(v, ranks[1][part][k]), f"{part}.{k}"
    assert torch.equal(ranks[0]["log_alpha"], ranks[1]["log_alpha"])
