"""One process of ``tests/test_torch_multihost.py``'s worlds across hosts.

``python _torch_multihost_worker.py run <run_rl arguments>``, started by
``torch.distributed.run`` once per rank: writes its pid, then runs
``run_rl.main`` with its arguments, and after training writes this rank's
parameters, train steps, host and replay contents to
``$PCRL_MH_OUT/rank<R>.pt``.

``python _torch_multihost_worker.py hosts``, started with the launcher
variables of a world of two hosts of one rank each: (a) the tiny SAC
slice with the parameters in ``$PCRL_MH_INIT`` and the noise pinned to
zero, each host's replay fed its own seeded pushes through
``replicate_rollout``, ``N_UPDATES`` updates recording every batch its
replay gives; (b) the episode statistics of two different windows over
the hosts, and of windows where host 1 has an info key host 0 lacks.
Writes ``$PCRL_MH_OUT/hosts<R>.pt``.

Imports nothing of JAX.
"""

import copy
import os
import os.path as osp
import sys

import numpy as np
import torch

sys.path.insert(0, osp.dirname(osp.abspath(__file__)))

from _torch_dp_worker import SLICE_CONFIG, agent_cfg_of, pinned_noise, transitions  # noqa: E402

from pointcloud_rl_torch.algorithms import build_agent  # noqa: E402
from pointcloud_rl_torch.env import build_replay  # noqa: E402
from pointcloud_rl_torch.parallel import replicate_rollout, setup_data_parallel  # noqa: E402
from pointcloud_rl_torch.parallel.distributed import (  # noqa: E402
    host_index, init_distributed, is_host_lead, mean_over_hosts, setup_hosts)
from pointcloud_rl_torch.utils.stats import EpisodicStatistics  # noqa: E402
from pointcloud_rl_torch.utils.tree_ops import tree_map  # noqa: E402

torch.set_num_threads(1)

N_UPDATES = 3
PUSHES = 200
INFO_KEYS = {"success": [True, "max", "mean"], "grasp": [True, "mean", "all"]}


def run(argv):
    """``run_rl.main(argv)`` with this rank's state written after training."""
    from pointcloud_rl_torch.apis import run_rl

    out_dir = os.environ["PCRL_MH_OUT"]
    rank = int(os.environ["RANK"])
    with open(osp.join(out_dir, f"pid{rank}"), "w") as f:
        f.write(str(os.getpid()))
    train_rl = run_rl.train_rl

    def recording(**kwargs):
        out = train_rl(**kwargs)
        agent, replay = kwargs["agent"], kwargs["replay"]
        state = agent.state_dict()
        n = len(replay)  # the replay has not wrapped
        torch.save({"model": state["model"], "target": state["target"], "log_alpha": state["log_alpha"],
                    "steps": out["steps"], "host": host_index(), "host_lead": is_host_lead(),
                    "replay": tree_map(lambda x: np.array(x[:n]), replay.memory)},
                   osp.join(out_dir, f"rank{rank}.pt"))
        return out

    run_rl.train_rl = recording
    run_rl.main(argv)


class StubRollout:
    """A host lead's collection: seeded transitions pushed as a rollout pushes them."""

    num_envs = 1
    pipeline_groups = 1

    def __init__(self, seed):
        self.data = transitions(PUSHES, seed=seed)

    def forward_with_policy(self, pi, num, replay=None, **kwargs):
        replay.push_batch(self.data)
        return {}


def local_batch(world):
    """(a): every update's batch is this rank's rows of its own host's sample."""
    agent = build_agent(agent_cfg_of(SLICE_CONFIG, {}))
    agent.load_params(torch.load(os.environ["PCRL_MH_INIT"]))
    replay = build_replay(dict(type="ReplayMemory", capacity=400), dict(seed=5), device="cpu")
    rollout = replicate_rollout(StubRollout(seed=7 + host_index()) if is_host_lead() else None)
    setup_data_parallel(agent, world, replay=replay)
    rollout.forward_with_policy(None, PUSHES, replay)
    samples, sample = [], replay.sample

    def recorded(batch_size):
        batch = sample(batch_size)
        samples.append(copy.deepcopy(batch))
        return batch

    replay.sample = recorded
    with pinned_noise():
        metrics = [agent.update_parameters(replay, u) for u in range(N_UPDATES)]
    state = agent.state_dict()
    return {"model": state["model"], "target": state["target"], "log_alpha": state["log_alpha"],
            "metrics": metrics, "samples": samples}


def window(host, n_episodes, keys):
    """Episode statistics of ``n_episodes`` seeded episodes of two workers,
    the info ``keys`` reported at every step."""
    rs = np.random.RandomState(100 + host)
    stats = EpisodicStatistics(2, INFO_KEYS)
    done = 0
    while done < n_episodes:
        infos = {k: rs.rand(2) for k in keys}
        done += stats.push(rs.randn(2), rs.rand(2) < 0.3, infos)
    return stats.get_stats()


def episode_stats():
    """(b): two different windows over the hosts, then host 1 with an extra key."""
    host = host_index()
    out = {}
    for name, keys in (("same_keys", ["success"]), ("extra_key", ["success"] + (["grasp"] if host == 1 else []))):
        local = window(host, 3 + 2 * host, keys)
        out[name] = {"local": local, "reduced": mean_over_hosts(local)}
    return out


def hosts():
    if not init_distributed(device="cpu"):
        raise RuntimeError("the hosts scenarios need a world (WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT)")
    layout = setup_hosts()
    world = torch.distributed.get_world_size()
    rank = torch.distributed.get_rank()
    results = {"hosts": layout.hosts, "host": host_index(), "host_lead": is_host_lead(),
               "local_batch": local_batch(world), "episode_stats": episode_stats()}
    torch.save(results, osp.join(os.environ["PCRL_MH_OUT"], f"hosts{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "run":
        run(sys.argv[2:])
    else:
        hosts()
