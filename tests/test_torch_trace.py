"""The port's spans (``pointcloud_rl_torch/utils/trace.py``) on the CPU.

(a) With no profiler session a span enters no ``record_function``, and the
rollout's log keys, which the spans' host seconds feed, are still there.
(b) Under a session, two cycles of ``train_rl`` on the tiny synthetic SAC
slice with a host replay (plain and pipelined collection) put every span
of the loop into the exported Chrome trace, each inside its parent.
(c) Every ``span(...)`` site of the package names a declared span, and
every declared span has a site.
"""

import ast
import json
import os
import os.path as osp
import time

import pytest
import torch

from pointcloud_rl_torch.utils import trace

torch.set_num_threads(1)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
PACKAGE = osp.join(REPO, "pointcloud_rl_torch")
SLICE_CONFIG = osp.join(REPO, "configs/mfrl/sac/synthetic/pn_fake_manipulation.py")
TINY = {
    "env_cfg.n_points": 64,
    "agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.mlp_spec": [16, 16, 32],
    "agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.out_channels": 16,
    "agent_cfg.actor_cfg.nn_cfg.mlp_cfg.mlp_spec": ["16 + agent_shape", 32, 32, "action_shape * 2"],
    "agent_cfg.critic_cfg.nn_cfg.mlp_cfg.mlp_spec": ["16 + agent_shape + action_shape", 32, 32, 1],
    "agent_cfg.batch_size": 16,
}
ENVS, N_STEPS, WARM, N_UPDATES = 2, 4, 16, 2
COLLECTIONS = {"plain": dict(pipeline_groups=1, action_lag=0), "pipelined": dict(pipeline_groups=2, action_lag=1)}
ROLLOUT_KEYS = ("agent_time", "simulation_time", "copy_time", "overhead_time")
# each span of the loop and the span it opens inside
PARENT = {
    trace.TRAIN_UPDATES: trace.TRAIN_CYCLE,
    trace.SAC_UPDATE: trace.TRAIN_UPDATES,
    trace.REPLAY_SAMPLE: trace.SAC_UPDATE,
    trace.ROLLOUT_COLLECT: trace.TRAIN_CYCLE,
    trace.ACT_DISPATCH: trace.ROLLOUT_COLLECT,
    trace.ACT_WAIT: trace.ROLLOUT_COLLECT,
    trace.ENV_WAIT: trace.ROLLOUT_COLLECT,
    trace.ROLLOUT_PUSH: trace.ROLLOUT_COLLECT,
}


class _Logs:
    def __init__(self):
        self.lines = []

    def log(self, values, step, tag):
        self.lines.append(dict(values))


def _train(collection, tmp_path, cycles=3, profile_steps=0):
    """``cycles`` cycles of ``train_rl`` on the tiny slice, a host replay and
    ``ENVS`` thread envs; returns the logged lines."""
    from pointcloud_rl_torch.algorithms import build_agent
    from pointcloud_rl_torch.apis.train_rl import train_rl
    from pointcloud_rl_torch.config import Config
    from pointcloud_rl_torch.env import get_env_info
    from pointcloud_rl_torch.env.replay import ReplayMemory
    from pointcloud_rl_torch.env.rollout import Rollout
    from pointcloud_rl_torch.models import get_kwargs_from_shape, replace_placeholder_with_args

    cfg = Config.fromfile(SLICE_CONFIG)
    cfg.merge_from_dict(TINY)
    env_cfg = dict(cfg["env_cfg"])
    env_info = get_env_info(env_cfg)
    kwargs = get_kwargs_from_shape(env_info["obs_shape"], env_info["action_shape"])
    agent_cfg = dict(replace_placeholder_with_args(dict(cfg["agent_cfg"]), **kwargs))
    agent = build_agent(dict(agent_cfg, env_params=env_info, seed=0, device="cpu"))
    rollout = Rollout(env_cfg=env_cfg, num_procs=ENVS, base_seed=0, vec_backend="thread", device="cpu",
                      **COLLECTIONS[collection])
    logs = _Logs()
    try:
        train_rl(agent, rollout, None, ReplayMemory(capacity=200, seed=0), work_dir=str(tmp_path), exp_logger=logs,
                 total_steps=WARM + cycles * N_STEPS, warm_steps=WARM, n_steps=N_STEPS, n_updates=N_UPDATES,
                 n_log=N_STEPS, n_eval=-1, n_checkpoint=-1, profile_steps=profile_steps)
    finally:
        rollout.close()
    return logs.lines


# ------------------------------------------------------- (a) no session
@pytest.mark.parametrize("collection", sorted(COLLECTIONS))
def test_spans_enter_no_record_function_without_a_session(collection, tmp_path, monkeypatch):
    real = torch.autograd.profiler.record_function

    def refused(name, *args, **kwargs):  # torch's own record_functions (the optimizers') pass
        if name in trace.NAMES:
            raise AssertionError(f"record_function entered for {name} with no profiler session")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refused)
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    lines = _train(collection, tmp_path)
    train_lines = [line for line in lines if "agent_time" in line]
    assert len(train_lines) == 3
    for line in train_lines:
        for key in ROLLOUT_KEYS + ("update_time", "collect_sample_time"):
            assert line[key] > 0, (key, line)


def test_a_span_off_is_the_shared_null_context_or_a_clock():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert trace.span(trace.SAC_UPDATE) is trace.span(trace.GRAPHS_REPLAY)  # one shared null context
    before = dict(trace.seconds)
    with trace.span(trace.ENV_WAIT):
        time.sleep(0.002)
    assert trace.seconds[trace.ENV_WAIT] - before[trace.ENV_WAIT] >= 0.002
    assert all(trace.seconds[k] == before[k] for k in trace.TIMED if k != trace.ENV_WAIT)


def test_a_timed_span_in_a_session_is_recorded_and_keeps_its_seconds():
    before = trace.seconds[trace.ROLLOUT_PUSH]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span(trace.ROLLOUT_PUSH):
            time.sleep(0.002)
    assert trace.seconds[trace.ROLLOUT_PUSH] - before >= 0.002
    assert [e.name for e in prof.events()].count(trace.ROLLOUT_PUSH) == 1


def test_stream_clock_off_the_card_sums_host_seconds():
    clock = trace.StreamClock("cpu")
    for _ in range(2):
        with clock:
            time.sleep(0.002)
    assert clock.take() >= 0.004
    assert clock.take() == 0.0


# -------------------------------------------------- (b) under a session
@pytest.mark.parametrize("collection", sorted(COLLECTIONS))
def test_two_cycles_of_train_rl_put_every_span_in_the_trace(collection, tmp_path):
    _train(collection, tmp_path, profile_steps=2 * N_STEPS)
    with open(tmp_path / "profile" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") in trace.NAMES]
    by = {}
    for e in spans:
        by.setdefault(e["name"], []).append(e)
    assert len(by.get(trace.TRAIN_CYCLE, [])) == 2
    for child, parent in PARENT.items():
        assert by.get(child), f"no {child} span in the trace"
        for e in by[child]:
            inside = [p for p in by[parent] if p["tid"] == e["tid"] and p["ts"] <= e["ts"]
                      and e["ts"] + e["dur"] <= p["ts"] + p["dur"]]
            assert inside, f"a {child} span lies outside every {parent} span"
    # two updates a cycle, each one host gather
    assert len(by[trace.SAC_UPDATE]) == len(by[trace.REPLAY_SAMPLE]) == 2 * N_UPDATES


# ---------------------------------------------------- (c) the span sites
def _span_sites():
    """(file, line, the constant named) of every ``span(...)`` call in the
    package but the definition's module."""
    sites = []
    for root, _, files in os.walk(PACKAGE):
        for name in files:
            path = osp.join(root, name)
            if not name.endswith(".py") or path == trace.__file__:
                continue
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                fn = node.func
                if (fn.id if isinstance(fn, ast.Name) else getattr(fn, "attr", None)) != "span":
                    continue
                arg = node.args[0] if node.args else None
                const = arg.id if isinstance(arg, ast.Name) else getattr(arg, "attr", None)
                sites.append((osp.relpath(path, REPO), node.lineno, const))
    return sites


def test_every_span_site_names_a_declared_span_and_every_span_has_a_site():
    declared = {k: v for k, v in vars(trace).items() if k.isupper() and not k.startswith("_") and isinstance(v, str)}
    assert sorted(declared.values()) == sorted(trace.NAMES) and len(set(trace.NAMES)) == len(trace.NAMES)
    sites = _span_sites()
    bad = [s for s in sites if s[2] not in declared]
    assert not bad, f"span sites that name no declared span: {bad}"
    assert {declared[s[2]] for s in sites} == set(trace.NAMES)
    assert set(trace.TIMED) <= set(trace.NAMES)
