"""One process of ``tests/test_torch_parallel.py``'s data-parallel world.

Run with ``WORLD_SIZE``/``RANK``/``MASTER_ADDR``/``MASTER_PORT`` in the
environment (the launcher variables ``parallel.init_distributed`` reads),
or without them as the 1-rank reference.  A rank of a world of two checks
the primitives (``is_lead_process``, ``allreduce_stats``, ``DistVar``),
then every process runs each scenario below on the tiny SAC slice and
writes its agent's parameters and metrics to ``PCRL_DP_OUT``:

- ``sac_jax``: SAC with the parameters the test converted from the JAX
  agent and the Gaussian noise pinned to zero, on the test's fixed batch;
- ``sac``, ``drq``, ``recurrent``, ``ddpg``, ``clip``: the noise on, on a
  replay fed the same transitions in every process (``drq`` on a
  ``DeviceReplayMemory``; ``recurrent`` samples GRU windows; ``clip``
  clips both optimizers' global gradient norm).

Imports nothing of JAX.
"""

import contextlib
import copy
import os
import os.path as osp
import sys
import time

import numpy as np
import torch

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, REPO)

from pointcloud_rl_torch.algorithms import build_agent  # noqa: E402
from pointcloud_rl_torch.config import Config  # noqa: E402
from pointcloud_rl_torch.env import build_replay, get_env_info  # noqa: E402
from pointcloud_rl_torch.models import get_kwargs_from_shape, replace_placeholder_with_args  # noqa: E402
from pointcloud_rl_torch.parallel import (  # noqa: E402
    DistVar, allreduce_stats, init_distributed, is_lead_process, setup_data_parallel)

torch.set_num_threads(1)

SLICE_CONFIG = osp.join(REPO, "configs/mfrl/sac/synthetic/pn_fake_manipulation.py")
DRQ_CONFIG = osp.join(REPO, "configs/mfrl/drq/synthetic/pn_jitter_fake_manipulation.py")
# the tiny slice of tests/test_torch_models.py: 64 points, PointNet [16,16,32] -> 16, heads 32, batch 16
TINY = {
    "env_cfg.n_points": 64,
    "agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.mlp_spec": [16, 16, 32],
    "agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.out_channels": 16,
    "agent_cfg.actor_cfg.nn_cfg.mlp_cfg.mlp_spec": ["16 + agent_shape", 32, 32, "action_shape * 2"],
    "agent_cfg.critic_cfg.nn_cfg.mlp_cfg.mlp_spec": ["16 + agent_shape + action_shape", 32, 32, 1],
    "agent_cfg.batch_size": 16,
    "agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.fused": True,
}
N_UPDATES = 3
# (config, overrides, replay_cfg)
SCENARIOS = {
    "sac_jax": (SLICE_CONFIG, {}, None),
    "sac": (SLICE_CONFIG, {}, dict(type="ReplayMemory", capacity=400)),
    "drq": (DRQ_CONFIG, {"agent_cfg.obs_aug": [
        dict(type="RandomJitterPoints", main_key="xyz", req_keys=["xyz"], jitter_range=[-0.01, 0.01]),
        dict(type="GlobalRotScaleTrans", main_key="xyz", req_keys=["xyz"], translation_range=[0.1, 0.1, 0.1])]},
        dict(type="DeviceReplayMemory", capacity=400)),
    "recurrent": (SLICE_CONFIG, {"agent_cfg.actor_cfg.nn_cfg.rnn_cfg": dict(type="GRU", hidden_size=16)},
                  dict(type="ReplayMemory", capacity=400, sampling_cfg=dict(type="TStepTransition", horizon=4))),
    "ddpg": (SLICE_CONFIG, {"agent_cfg.type": "DDPG"}, dict(type="ReplayMemory", capacity=400)),
    "clip": (SLICE_CONFIG, {"agent_cfg.actor_cfg.optim_cfg.max_grad_norm": 0.05,
                            "agent_cfg.critic_cfg.optim_cfg.max_grad_norm": 0.05},
             dict(type="ReplayMemory", capacity=400)),
}


def agent_cfg_of(config, overrides):
    cfg = Config.fromfile(config)
    cfg.merge_from_dict(dict(TINY, **overrides))
    env_info = get_env_info(dict(cfg["env_cfg"]))
    kwargs = get_kwargs_from_shape(env_info["obs_shape"], env_info["action_shape"])
    agent_cfg = dict(replace_placeholder_with_args(dict(cfg["agent_cfg"]), **kwargs))
    return dict(agent_cfg, env_params=env_info, seed=0, device="cpu")


def transitions(n, seed, n_points=64, episode_len=10):
    """Fake-manipulation-shaped transitions in episodes of ``episode_len``."""
    rs = np.random.RandomState(seed)

    def obs():
        return {"xyz": rs.randn(n, 3, n_points).astype(np.float32),
                "rgb": rs.randint(0, 256, (n, 3, n_points)).astype(np.uint8),
                "seg": (rs.rand(n, 2, n_points) < 0.3).astype(np.float32),
                "state": rs.randn(n, 32).astype(np.float32)}

    ends = (np.arange(n) % episode_len == episode_len - 1)[:, None]
    return dict(obs=obs(), next_obs=obs(), actions=np.clip(rs.randn(n, 8), -0.99, 0.99).astype(np.float32),
                rewards=rs.randn(n, 1).astype(np.float32), dones=ends & (rs.rand(n, 1) < 0.5),
                episode_dones=ends, worker_indices=np.zeros((n, 1), np.int64))


class FixedMemory:
    """``sample`` returns the same batch every call."""

    def __init__(self, batch):
        self.batch = batch

    def sample(self, batch_size):
        return copy.deepcopy(self.batch)


@contextlib.contextmanager
def pinned_noise():
    """Zero Gaussian noise in the tanh head (as tests/test_torch_sac.py pins it)."""
    from pointcloud_rl_torch.models import distributions as td
    from pointcloud_rl_torch.models import heads

    def zero(generator, mean, std, scale, bias, epsilon=1e-6):
        return td.tanh_transform(mean, scale, bias), td.tanh_log_prob_with_logit(mean, mean, std, scale, epsilon)

    drawn = heads.tanh_normal_rsample_with_log_prob
    heads.tanh_normal_rsample_with_log_prob = zero
    try:
        yield
    finally:
        heads.tanh_normal_rsample_with_log_prob = drawn


def run_scenario(name, world):
    config, overrides, replay_cfg = SCENARIOS[name]
    agent = build_agent(agent_cfg_of(config, overrides))
    if name == "sac_jax":
        agent.load_params(torch.load(os.environ["PCRL_DP_INIT"]))
        memory = FixedMemory(torch.load(os.environ["PCRL_DP_BATCH"], weights_only=False))
    else:
        memory = build_replay(replay_cfg, dict(seed=5), device="cpu")
        data = transitions(200, seed=7)
        for lo in range(0, 200, 50):  # in pushes, as a rollout makes them
            memory.push_batch({k: ({kk: vv[lo:lo + 50] for kk, vv in v.items()} if isinstance(v, dict)
                                   else v[lo:lo + 50]) for k, v in data.items()})
    if world > 1:
        setup_data_parallel(agent, world, replay=memory if replay_cfg else None)
    metrics = [agent.update_parameters(memory, u) for u in range(N_UPDATES)]
    state = agent.state_dict()
    return {"model": state["model"], "target": state["target"], "log_alpha": state["log_alpha"],
            "metrics": metrics}


def primitives(rank):
    """The JAX package's multi-host checks (tests/_multihost_worker.py)."""
    assert is_lead_process() == (rank == 0)
    out = {"sum": allreduce_stats({"r": float(rank), "n": 1.0}, op="sum"),
           "max": allreduce_stats({"r": float(rank)}, op="max"),
           "mean": allreduce_stats({"r": float(rank)}, op="mean")}
    try:
        allreduce_stats({"r": 0.0}, op="median")
    except KeyError:
        out["unknown_op"] = "KeyError"
    var = DistVar("pod_test")
    if rank == 0:
        var.add(3)
    deadline = time.monotonic() + 30
    while var.get() < 3:
        assert time.monotonic() < deadline, "DistVar increment never observed"
        time.sleep(0.01)
    out["distvar"] = var.get()
    return out


def main():
    out_dir = os.environ["PCRL_DP_OUT"]
    joined = init_distributed(device="cpu")
    world = torch.distributed.get_world_size() if joined else 1
    rank = torch.distributed.get_rank() if joined else 0
    results = {"joined": joined}
    if joined:
        results["primitives"] = primitives(rank)
    for name in SCENARIOS:
        if name == "sac_jax" and "PCRL_DP_INIT" not in os.environ:
            continue  # run alone, without the test's JAX parameters
        with pinned_noise() if name == "sac_jax" else contextlib.nullcontext():
            results[name] = run_scenario(name, world)
    torch.save(results, osp.join(out_dir, f"world{world}_rank{rank}.pt"))
    if joined:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
