"""The port's update programs against the JAX package's.

``update_parameters_lazy``, ``update_parameters_scan`` (and its fallback to
lazy updates), the act-fused updates and ``train_rl``'s choice among them
are held against the JAX package on the CPU, where the port runs each
program's eager body.  On a card each program is a captured CUDA graph
(``algorithms/graphs.py``); the ``gpu``-marked tests hold graphed updates
bitwise against eager ones from the same state.  The card's machine has no
JAX, so JAX is imported inside the tests that compare with it; there the
``gpu`` tests run as
``python -m pytest --noconftest -m gpu tests/test_torch_update_programs.py``.
"""

import copy
import os.path as osp
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, osp.dirname(__file__))

torch.set_num_threads(1)

_REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
N_UPDATES = 4
LR = 1e-3  # the slice config's actor and critic Adam lr
METRIC_RTOL = 1e-3  # f32 sums in another order, through 4 updates


def _jax_pair(**overrides):
    """The slice's JAX agent and the port's, with the JAX parameters."""
    from test_torch_models import slice_setup

    from pointcloud_rl_torch.algorithms import build_agent as t_build_agent
    from pointcloud_rl_torch.convert import params_from_jax
    from pointcloud_rl_tpu.algorithms import build_agent as j_build_agent

    agent_cfg, env_info, _ = slice_setup(fused=True, **overrides)
    j_agent = j_build_agent(dict(agent_cfg, env_params=env_info, seed=0))
    t_agent = t_build_agent(dict(agent_cfg, env_params=env_info, seed=0, device="cpu"))
    st = j_agent.train_state
    t_agent.load_params(params_from_jax(st.params, st.target_params, st.log_alpha))
    return j_agent, t_agent


# ------------------------------------------------------------ lazy updates
def test_lazy_updates_and_their_reduce_match_jax(monkeypatch):
    """Four lazy updates on one host batch, their vectors summed on the
    device and reduced once, against the JAX package's."""
    from test_torch_recurrent import assert_params_track
    from test_torch_sac import _batch, _FixedMemory, _pin_noise

    _pin_noise(monkeypatch)
    j_agent, t_agent = _jax_pair()
    batch = _batch()
    j_sum = t_sum = None
    for u in range(N_UPDATES):
        j_vec = j_agent.update_parameters_lazy(_FixedMemory(batch), u)
        t_vec = t_agent.update_parameters_lazy(_FixedMemory(batch), u)
        assert isinstance(t_vec, torch.Tensor) and t_vec.shape == (len(t_agent._metric_keys),)
        j_sum = j_vec if j_sum is None else j_sum + j_vec
        t_sum = t_vec if t_sum is None else t_sum + t_vec
    assert t_agent._metric_keys == j_agent.metric_keys and t_agent.updates == N_UPDATES
    j_m, t_m = j_agent.reduce_metric_vecs(j_sum, N_UPDATES), t_agent.reduce_metric_vecs(t_sum, N_UPDATES)
    assert sorted(t_m) == sorted(j_m)
    for key, a in j_m.items():
        assert abs(a - t_m[key]) < METRIC_RTOL * (1 + abs(a)), f"{key}: jax {a} vs torch {t_m[key]}"
    assert t_m["sac/grad_steps"] == N_UPDATES
    assert_params_track(j_agent, t_agent, N_UPDATES, LR)


# ------------------------------------------------------ the scan's fallback
def _obs_rms_cfg(obs_dim=5, act_dim=2):
    from test_torch_sac_variants import _Box

    def mlp(inp, out):
        return dict(type="LinearMLP", norm_cfg=None, mlp_spec=[inp, 32, out], inactivated_output=True)

    return dict(
        type="SAC", batch_size=16, gamma=0.9, obs_rms=True,
        env_params=dict(is_discrete=False, obs_shape=obs_dim, action_shape=act_dim, action_space=_Box(act_dim)),
        actor_cfg=dict(type="ContinuousActor", head_cfg=dict(type="TanhGaussianHead", log_std_bound=[-10, 2]),
                       nn_cfg=mlp(obs_dim, 2 * act_dim), optim_cfg=dict(type="Adam", lr=1e-3)),
        critic_cfg=dict(type="ContinuousCritic", num_heads=2, nn_cfg=mlp(obs_dim + act_dim, 1),
                        optim_cfg=dict(type="Adam", lr=1e-3)))


def _fallback_pair(agent):
    """(JAX agent, port agent) for each case of the scan's rule."""
    from test_torch_recurrent import build_pair

    if agent == "recurrent":
        j_agent, t_agent, _ = build_pair()
        return j_agent, t_agent
    if agent == "obs_rms":
        from pointcloud_rl_torch.algorithms import build_agent as t_build_agent
        from pointcloud_rl_tpu.algorithms import build_agent as j_build_agent

        cfg = _obs_rms_cfg()
        return j_build_agent(dict(cfg, seed=0)), t_build_agent(dict(cfg, seed=0, device="cpu"))
    return _jax_pair()


@pytest.mark.parametrize("agent, replay", [("feed_forward", "device"), ("feed_forward", "host"),
                                           ("recurrent", "device"), ("obs_rms", "device")])
def test_scan_falls_back_to_lazy_updates_like_jax(agent, replay):
    """``update_parameters_scan(memory, 3)``: one storage program over a
    ``DeviceReplayMemory`` with a feed-forward model and no ``obs_rms``,
    else three lazy updates, in both packages."""
    from test_torch_sac import _FixedMemory

    from pointcloud_rl_torch.env.device_replay import DeviceReplayMemory as TDevice
    from pointcloud_rl_tpu.env.device_replay import DeviceReplayMemory as JDevice

    j_agent, t_agent = _fallback_pair(agent)
    calls = {"jax": [], "torch": []}

    def lazy(side):
        def run(memory, updates):
            calls[side].append(("lazy",))
            return np.ones(3, np.float32) if side == "jax" else torch.ones(3)
        return run

    def j_scan(state, storage, size, n):
        calls["jax"].append(("scan", n))
        return state, np.ones(3, np.float32)

    def t_program(kind, n, body, inputs=None, memory=None):
        calls["torch"].append(("scan", n))
        return (torch.ones(3),)

    j_agent.update_parameters_lazy, t_agent.update_parameters_lazy = lazy("jax"), lazy("torch")
    j_agent._storage_scan_jit, t_agent._program = j_scan, t_program
    if replay == "device":
        j_mem, t_mem = JDevice(64, seed=0), TDevice(64, seed=0, device="cpu")
    else:
        j_mem = t_mem = _FixedMemory(None)
    j_vec, t_vec = j_agent.update_parameters_scan(j_mem, 3), t_agent.update_parameters_scan(t_mem, 3)
    assert calls["torch"] == calls["jax"]
    want = [("scan", 3)] if (agent, replay) == ("feed_forward", "device") else [("lazy",)] * 3
    assert calls["torch"] == want
    np.testing.assert_array_equal(t_vec.numpy(), np.asarray(j_vec))


# ------------------------------------------------------ act-fused updates
def test_act_fused_updates_keep_the_jax_bookkeeping():
    """``tests/test_integration_extra.py::test_act_fused_updates`` on both
    packages side by side: the same ``done`` after each explore forward,
    the same update count, eval forwards never fuse, a host replay refuses
    to arm.  On the port, the fused actions are an eager chunk of updates
    then the act, from the same state."""
    from test_algorithms import _state_agent_cfg, _state_data

    from pointcloud_rl_torch.algorithms import build_agent as t_build_agent
    from pointcloud_rl_torch.env.device_replay import DeviceReplayMemory as TDevice
    from pointcloud_rl_torch.env.replay import ReplayMemory as THost
    from pointcloud_rl_tpu.algorithms import build_agent as j_build_agent
    from pointcloud_rl_tpu.env import DeviceReplayMemory as JDevice
    from pointcloud_rl_tpu.env import ReplayMemory as JHost

    cfg = _state_agent_cfg(obs_dim=4, action_dim=3, batch_size=16)
    data = _state_data(n=64, obs_dim=4, action_dim=3)
    obs = np.random.RandomState(1).randn(4, 4).astype(np.float32)
    j_agent, t_agent = j_build_agent(copy.deepcopy(cfg)), t_build_agent(dict(copy.deepcopy(cfg), device="cpu"))
    j_mem, t_mem = JDevice(capacity=256, seed=0), TDevice(256, seed=0, device="cpu")
    j_mem.push_batch(data)
    t_mem.push_batch(data)

    done = {"jax": [], "torch": []}
    for side, agent, mem in (("jax", j_agent, j_mem), ("torch", t_agent, t_mem)):
        assert agent.set_fused_updates(mem, chunk=2, budget=4)
        for _ in range(3):
            actions = agent.forward(obs, mode="explore")
            assert actions.shape == (4, 3)
            done[side].append(agent._fused_plan["done"])
        vec, n = agent.finish_fused_updates()
        assert n == 4 and vec is not None and agent._fused_plan is None
        assert all(np.isfinite(v) for v in agent.reduce_metric_vecs(vec, n).values())
        assert agent.set_fused_updates(mem, chunk=1, budget=8)
        agent.forward(obs, mode="eval")
        assert agent.finish_fused_updates() == (None, 0)
        host = JHost(capacity=64) if side == "jax" else THost(capacity=64)
        assert not agent.set_fused_updates(host, chunk=1, budget=4)
    assert done["torch"] == done["jax"] == [2, 4, 4]
    assert t_agent.updates == int(j_agent.train_state.updates) == 4

    # the port's fused forwards against 2 eager updates then the explore
    # act, then a plain act, from the same state and the same replay draws
    fused, twin = (t_build_agent(dict(copy.deepcopy(cfg), device="cpu")) for _ in range(2))
    start = TDevice(256, seed=0, device="cpu").generator.get_state()
    t_mem.generator.set_state(start)
    assert fused.set_fused_updates(t_mem, chunk=2, budget=4)
    got = [fused.forward(obs, mode="explore") for _ in range(3)]
    t_mem.generator.set_state(start)
    want = []
    for step in range(3):
        if step < 2:
            twin._update_vecs(t_mem, 2)
        with torch.no_grad():
            want.append(twin.act(twin._upload_obs(obs), "explore").numpy())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert fused.updates == twin.updates == 4


# ------------------------------------------------- train_rl's program choice
class _Vec:
    """A metric vector: sums like a device tensor and records any fetch."""

    def __init__(self, n, log):
        self.n, self.log = n, log

    def __add__(self, other):
        return _Vec(self.n + other.n, self.log)

    def _fetch(self, *args, **kwargs):
        self.log.append(("fetch",))
        return np.array([self.n], np.float64)

    __array__ = cpu = numpy = tolist = item = __float__ = _fetch


class _ProgramAgent:
    """What both ``train_rl`` loops call on an agent, recorded: the act
    dispatches, ``update_parameters_scan``, ``update_parameters_lazy``, the
    act-fused plan and its chunks, ``reduce_metric_vecs``; a fetch of a
    metric vector anywhere else, and ``update_parameters``, are recorded
    too and must not happen."""

    def __init__(self, torch_side, action_dim):
        if torch_side:
            from pointcloud_rl_torch.parallel import DataParallel

            self.data_parallel = DataParallel()
            self.device = torch.device("cpu")
        self.events, self.action_dim, self.plan = [], action_dim, None

    def train(self):
        return self

    def eval(self):
        return self

    def forward_async(self, obs, mode="explore"):
        from pointcloud_rl_torch.algorithms.base import ActionHandle

        n = len(obs["xyz"])
        plan = self.plan
        if mode == "explore" and plan is not None and plan["budget"] >= plan["chunk"]:
            plan["budget"] -= plan["chunk"]
            plan["done"] += plan["chunk"]
            self.events.append(("fused_act", n, len(plan["mem"]), plan["chunk"]))
        else:
            self.events.append(("act", n))
        return ActionHandle(np.zeros((n, self.action_dim), np.float32))

    def update_parameters_scan(self, memory, n):
        self.events.append(("scan", len(memory), n))
        return _Vec(n, self.events)

    def update_parameters_lazy(self, memory, updates):
        self.events.append(("lazy", len(memory), updates))
        return _Vec(1, self.events)

    def update_parameters(self, memory, updates):
        self.events.append(("update", len(memory)))
        return {"x": 1.0}

    def set_fused_updates(self, memory, chunk, budget, announce=None):
        self.events.append(("arm", len(memory), chunk, budget))
        self.plan = {"mem": memory, "chunk": chunk, "budget": budget, "done": 0}
        return True

    def finish_fused_updates(self):
        plan, self.plan = self.plan, None
        self.events.append(("finish", plan["done"]))
        return (_Vec(plan["done"], self.events) if plan["done"] else None), plan["done"]

    def reduce_metric_vecs(self, vec_sum, count):
        assert vec_sum.n == count
        self.events.append(("reduce", count))
        return {"updates": float(count)}

    def state_dict(self):
        return {"w": np.zeros(2, np.float32)}


class DeviceReplayMemory:
    """A stub replay, named as both loops recognise an on-device one."""

    def __init__(self):
        self.n = 0

    def __len__(self):
        return self.n

    def push_batch(self, batch):
        self.n += len(batch["rewards"])


class HostReplay(DeviceReplayMemory):
    pass


def _loop_events(side, replay_kind, n_updates, fused, tmp_path):
    from test_torch_models import slice_setup

    if side == "torch":
        from pointcloud_rl_torch.apis.train_rl import train_rl
        from pointcloud_rl_torch.env.rollout import Rollout
        extra = dict(device="cpu")
    else:
        from pointcloud_rl_tpu.apis.train_rl import train_rl
        from pointcloud_rl_tpu.env import Rollout
        extra = {}
    _, env_info, env_cfg = slice_setup()
    agent = _ProgramAgent(side == "torch", env_info["action_shape"])
    replay = DeviceReplayMemory() if replay_kind == "device" else HostReplay()
    rollout = Rollout(env_cfg=env_cfg, num_procs=4, base_seed=0, vec_backend="thread", pipeline_groups=2,
                      **extra)
    try:
        train_rl(agent, rollout, None, replay, work_dir=str(tmp_path / side), total_steps=8 + 4 * 8, warm_steps=8,
                 n_steps=8, n_updates=n_updates, n_log=16, n_eval=-1, n_checkpoint=-1, act_fused_updates=fused)
    finally:
        rollout.close()
    return agent.events


@pytest.mark.parametrize("replay_kind, n_updates, fused", [("host", 4, False), ("host", 1, False),
                                                           ("device", 5, False), ("device", 5, True),
                                                           ("device", 1, True)],
                         ids=["scan_per_cycle", "lazy_per_update", "interleaved", "act_fused", "one_update_lazy"])
def test_train_rl_takes_the_jax_loops_programs(replay_kind, n_updates, fused, tmp_path):
    """One stub agent through both packages' ``train_rl``: the same
    sequence of act dispatches, scans, lazy updates, act-fused chunks and
    reduces; no ``update_parameters`` and no fetch of a metric vector but
    the one reduce per log interval."""
    t_events = _loop_events("torch", replay_kind, n_updates, fused, tmp_path)
    j_events = _loop_events("jax", replay_kind, n_updates, fused, tmp_path)
    assert t_events == j_events
    kinds = [e[0] for e in t_events]
    assert "update" not in kinds and "fetch" not in kinds
    assert kinds.count("reduce") == 2  # 32 env steps, a log line every 16
    programs = [e for e in t_events if e[0] in ("scan", "lazy", "fused_act")]
    if n_updates == 1:
        assert [e[0] for e in programs] == ["lazy"] * 4
    elif replay_kind == "host":
        assert programs == [("scan", 16 + 8 * c, n_updates) for c in range(4)]  # after each push
    elif fused:
        # each cycle: 4 acts of 2 envs each take a chunk of 1 on the buffer before the push, then a scan of 1
        want = []
        for c in range(4):
            want += [("fused_act", 2, 8 + 8 * c, 1)] * 4 + [("scan", 16 + 8 * c, 1)]
        assert programs == want and kinds.count("arm") == 4
    else:
        assert "fused_act" not in kinds and "arm" not in kinds


# --------------------------------------------------- the replay's device size
def test_device_size_draw_stays_in_range_as_the_ring_grows_and_wraps():
    """``device_size`` follows every push and the ring's wrap; every index
    drawn against it lies in ``[0, len)`` and the draws reach both ends."""
    from pointcloud_rl_torch.env.device_replay import DeviceReplayMemory as TDevice

    mem = TDevice(10, seed=0, device="cpu")
    version = mem.storage_version
    for push in range(8):
        mem.push_batch({"obs": np.full((3, 2), push, np.float32), "rewards": np.zeros(3, np.float32)})
        n = len(mem)
        assert n == min(3 * (push + 1), 10) and int(mem.device_size) == n
        idx = torch.cat([mem._draw_indices(64) for _ in range(20)])
        assert idx.dtype == torch.int64 and int(idx.min()) == 0 and int(idx.max()) == n - 1
    assert mem.storage_version == version + 1  # made once, at the first push
    mem.reset()
    assert len(mem) == 0 and int(mem.device_size) == 0


# ------------------------------------------------------ the optimizers' state
def test_a_loaded_optimizer_state_keeps_the_capturable_flag():
    """A state saved by a non-capturable Adam (a CPU agent's, or an older
    checkpoint's) loaded into a capturable one (a card agent's, whose
    graphs capture the step) keeps the flag and gets its step count as an
    f32 tensor beside the parameters, and steps as before."""
    from pointcloud_rl_torch.algorithms.optim import Optimizer

    def make(capturable):
        w = torch.nn.Parameter(torch.ones(3))
        opt = Optimizer(dict(type="Adam", lr=0.1), [("critic.w", w)])
        opt.opt.param_groups[0]["capturable"] = capturable  # as a card's Adam is built
        return w, opt

    w_src, src = make(False)
    src.step([torch.full((3,), 0.5)])
    w_dst, dst = make(True)
    with torch.no_grad():
        w_dst.copy_(w_src)
    dst.load_state_dict(src.state_dict())
    group, state = dst.opt.param_groups[0], dst.opt.state[w_dst]
    assert group["capturable"] and state["step"].dtype == torch.float32 and float(state["step"]) == 1.0
    assert torch.equal(state["exp_avg"], src.opt.state[w_src]["exp_avg"])
    src.load_state_dict(dst.state_dict())
    assert not src.opt.param_groups[0]["capturable"]


# ------------------------------------------------------------- on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


TINY = {
    "env_cfg.n_points": 64,
    "agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.mlp_spec": [16, 16, 32],
    "agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.out_channels": 16,
    "agent_cfg.actor_cfg.nn_cfg.mlp_cfg.mlp_spec": ["16 + agent_shape", 32, 32, "action_shape * 2"],
    "agent_cfg.critic_cfg.nn_cfg.mlp_cfg.mlp_spec": ["16 + agent_shape + action_shape", 32, 32, 1],
    "agent_cfg.batch_size": 16,
}
FUSED = {"agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.fused": True}
_V = "agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg."
SLICES = {  # config, overrides at test size
    "sac": ("configs/mfrl/sac/synthetic/pn_fake_manipulation.py", FUSED),
    "drq": ("configs/mfrl/drq/synthetic/pn_jitter_fake_manipulation.py", FUSED),
    "recurrent": ("configs/mfrl/sac/synthetic/pn_fake_manipulation.py",
                  dict(FUSED, **{"agent_cfg.actor_cfg.nn_cfg.rnn_cfg": {"type": "GRU", "hidden_size": 16}})),
    "ddpg": ("configs/mfrl/sac/synthetic/pn_fake_manipulation.py", dict(FUSED, **{"agent_cfg.type": "DDPG"})),
    "voxel": ("configs/mfrl/drq/synthetic/sparse_conv_shift_fake_manipulation.py",
              {_V + "grid_size": [8, 8, 8], _V + "stem_channels": [8, 8]}),
}


def _card_agents(kind, bf16=False):
    """Two agents of a tiny slice on the card, the second with the first's
    state, and a filled ``DeviceReplayMemory``."""
    from pointcloud_rl_torch.algorithms import build_agent
    from pointcloud_rl_torch.config import Config
    from pointcloud_rl_torch.env import get_env_info
    from pointcloud_rl_torch.env.device_replay import DeviceReplayMemory as TDevice
    from pointcloud_rl_torch.models import get_kwargs_from_shape, replace_placeholder_with_args

    config, overrides = SLICES[kind]
    cfg = Config.fromfile(osp.join(_REPO, config))
    cfg.merge_from_dict(dict(TINY, **overrides, **{"agent_cfg.bf16": bf16}))
    env_info = get_env_info(dict(cfg["env_cfg"]))
    kwargs = get_kwargs_from_shape(env_info["obs_shape"], env_info["action_shape"])
    agent_cfg = dict(replace_placeholder_with_args(dict(cfg["agent_cfg"]), **kwargs), env_params=env_info,
                     seed=0, device="cuda")
    graphed, eager = build_agent(copy.deepcopy(agent_cfg)), build_agent(copy.deepcopy(agent_cfg))
    eager.load_state_dict(graphed.state_dict())
    mem = TDevice(512, seed=0, device="cuda", transfer_cfg=dict(pack_features=True) if bf16 else None)
    rs = np.random.RandomState(0)
    for _ in range(4):
        mem.push_batch(_transitions(rs, 48, env_info["action_shape"]))
    return graphed, eager, mem, env_info


def _transitions(rs, n, action_dim, n_points=64):
    def obs():
        return {"xyz": rs.randn(n, 3, n_points).astype(np.float32),
                "rgb": rs.randint(0, 256, (n, 3, n_points)).astype(np.uint8),
                "seg": (rs.rand(n, 2, n_points) < 0.3).astype(np.float32),
                "state": rs.randn(n, 32).astype(np.float32)}

    return {"obs": obs(), "next_obs": obs(), "actions": rs.uniform(-1, 1, (n, action_dim)).astype(np.float32),
            "rewards": rs.rand(n).astype(np.float32), "dones": rs.rand(n) < 0.1,
            "episode_dones": rs.rand(n) < 0.1}


def _assert_same_state(a, b, what):
    sa, sb = a.state_dict(), b.state_dict()
    for part in ("model", "target"):
        for k, v in sa[part].items():
            assert torch.equal(v, sb[part][k]), f"{what}: {part}.{k}"
    assert torch.equal(sa["log_alpha"], sb["log_alpha"]) and sa["updates"] == sb["updates"], what
    for opt in ("actor_opt", "critic_opt", "alpha_opt"):
        for i, st in sa[opt]["state"].items():
            for k, v in st.items():
                assert torch.equal(v, sb[opt]["state"][i][k]), f"{what}: {opt} {i} {k}"
    assert torch.equal(sa["generator"], sb["generator"]), what


@pytest.mark.gpu
@pytest.mark.parametrize("config, bf16", [("sac", True), ("drq", True), ("sac", False)],
                         ids=["sac_packed_bf16", "drq_packed_bf16", "sac_f32"])
def test_graphed_storage_scans_equal_eager_on_gpu(config, bf16):
    """Scans of 4 and 3 updates over a device replay, at both gate phases:
    each call's first run is eager, the next ones replay a graph; the
    graphed agent stays bitwise equal to an eager twin from the same state,
    and the replay's generator advances alike."""
    _card()
    graphed, eager, mem, env_info = _card_agents(config, bf16)
    for rnd in range(3):  # round 0 runs eagerly, rounds 1-2 replay graphs
        for n in (4, 3, 4, 3):  # phases 0, 0, 1, 1 of the interval-2 gates
            gen = mem.generator.get_state()
            got = graphed.update_parameters_scan(mem, n)
            after = mem.generator.get_state()
            mem.generator.set_state(gen)
            want = eager._update_vecs(mem, n)
            assert torch.equal(mem.generator.get_state(), after), (rnd, n)
            assert torch.equal(got, want), (rnd, n, got, want)
            _assert_same_state(graphed, eager, f"round {rnd}, scan of {n}")
        if rnd == 1:  # the graphs captured in round 1 sample the grown replay in round 2
            mem.push_batch(_transitions(np.random.RandomState(rnd), 40, env_info["action_shape"]))
    assert len(graphed._programs.programs) == 4


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["sac", "drq", "recurrent", "ddpg", "voxel"])
def test_graphed_host_batch_updates_equal_eager_on_gpu(kind):
    """The one-update program on host batches, copied into the graph's
    static inputs (a recurrent model's ``[B, H]`` windows), for every
    slice's agent: bitwise the eager update on the same batch, at both
    gate phases.  The voxel encoder's scatter (``index_add_``) and cuDNN's
    conv3d backward sum with atomics, in an order that changes from run to
    run (two eager updates differ in the last bits too), so its updates
    are held to f32 noise instead: metrics to ``VOXEL_RTOL``, and every
    parameter inside the envelope of Adam's sign flips (``2 * lr`` per
    update, as ``tests/test_torch_sac.py`` bounds them)."""
    _card()
    graphed, eager, _, env_info = _card_agents(kind)
    lr = max(g["lr"] for tx in (graphed.critic_tx, graphed.actor_tx) for g in tx.opt.param_groups)
    rs = np.random.RandomState(3)
    for u in range(8):  # phases 0 and 1 eagerly, then their captures, then replays
        batch = _transitions(rs, 16, env_info["action_shape"])
        if kind == "recurrent":
            batch = _windows(rs, env_info["action_shape"])
        got = graphed.update_parameters_lazy(_OneBatch(batch), u)
        want = eager._batch_update_vec(eager._prepare_batch(copy.deepcopy(batch)))
        if kind != "voxel":
            assert torch.equal(got, want), (u, got, want)
            _assert_same_state(graphed, eager, f"update {u}")
            continue
        torch.testing.assert_close(got, want, rtol=VOXEL_RTOL, atol=VOXEL_RTOL)
        for k, v in graphed.model.state_dict().items():
            assert float((v - eager.model.state_dict()[k]).abs().max()) <= 2 * lr * (u + 1) * 1.01, (u, k)
    assert len(graphed._programs.programs) == 2


VOXEL_RTOL = 1e-4  # f32 sums in another atomic order, over 8 updates


def _windows(rs, action_dim, b=16, h=3):
    flat = _transitions(rs, b * h, action_dim)
    win = {k: ({kk: vv.reshape((b, h) + vv.shape[1:]) for kk, vv in v.items()} if isinstance(v, dict)
               else v.reshape((b, h) + v.shape[1:])) for k, v in flat.items()}
    win["rewards"], win["dones"] = win["rewards"][..., None], win["dones"][..., None]
    win["episode_dones"] = win["episode_dones"][..., None]
    win["is_valid"] = np.ones((b, h), bool)
    win["is_valid"][1, 1:] = False
    return win


class _OneBatch:
    def __init__(self, batch, horizon=3):
        self.batch = batch
        self.sampling = type("Sampling", (), {"horizon": horizon})()

    def sample(self, batch_size):
        return copy.deepcopy(self.batch)

    def sample_windows(self, batch_size, horizon):
        return copy.deepcopy(self.batch)


@pytest.mark.gpu
def test_graphed_act_fused_chunks_equal_eager_on_gpu():
    """Act-fused forwards (2 updates then the explore act): the actions
    and the state bitwise those of 2 eager updates then the eager act."""
    _card()
    graphed, eager, mem, _ = _card_agents("sac", True)
    obs = _transitions(np.random.RandomState(5), 4, 8)["obs"]
    assert graphed.set_fused_updates(mem, chunk=2, budget=8)
    for step in range(4):  # the first runs eagerly, then a capture, then replays
        gen = mem.generator.get_state()
        got = graphed.forward(obs, mode="explore")
        mem.generator.set_state(gen)
        eager._update_vecs(mem, 2)
        with torch.no_grad():
            want = eager.act(eager._upload_obs(obs), "explore").cpu().numpy()
        np.testing.assert_array_equal(got, want)
        _assert_same_state(graphed, eager, f"fused forward {step}")
    vec, done = graphed.finish_fused_updates()
    assert done == 8 and bool(torch.isfinite(vec).all())


@pytest.mark.gpu
def test_a_programs_rebuilds_are_traced_and_counted_on_gpu():
    """Four scans of one key in a profiler session: the first runs eagerly
    (one ``graphs.eager`` span), the second captures (one ``graphs.capture``)
    and replays, the rest only replay (``graphs.replay``); the programs'
    counters say the same, and a host batch's program opens a
    ``graphs.upload`` before each replay."""
    from pointcloud_rl_torch.utils import trace

    _card()
    graphed, _, mem, env_info = _card_agents("sac")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def graph_spans(prof):  # the host's spans (the session also marks each span's range on the card)
        events = sorted((e for e in prof.events() if e.name.startswith("graphs.")
                         and e.device_type == torch.autograd.DeviceType.CPU), key=lambda e: e.time_range.start)
        return [e.name for e in events]

    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(4):
            graphed.update_parameters_scan(mem, 4)  # 4 updates: the gate phase, and so the key, stays
        torch.cuda.synchronize()
    assert graph_spans(prof) == [trace.GRAPHS_EAGER, trace.GRAPHS_CAPTURE] + [trace.GRAPHS_REPLAY] * 3
    stats = graphed._programs.stats()
    assert (stats["eager_runs"], stats["captures"], stats["invalidations"]) == (1, 1, 0)
    assert [p["replays"] for p in stats["programs"].values()] == [3]

    batch = _transitions(np.random.RandomState(4), 16, env_info["action_shape"])
    with torch.profiler.profile(activities=acts) as prof:
        for u in range(4):  # the interval-2 gates: two keys, each run eagerly, captured, replayed
            graphed.update_parameters_lazy(_OneBatch(batch), u)
        torch.cuda.synchronize()
    assert graph_spans(prof) == [trace.GRAPHS_EAGER] * 2 + [trace.GRAPHS_CAPTURE, trace.GRAPHS_UPLOAD,
                                                              trace.GRAPHS_REPLAY] * 2
    stats = graphed._programs.stats()
    assert (stats["eager_runs"], stats["captures"], stats["invalidations"]) == (3, 3, 0)
    graphed.drop_programs()
    assert graphed._programs.stats()["invalidations"] == 1
