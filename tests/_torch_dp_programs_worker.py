"""One gloo rank of ``tests/test_torch_dp_programs.py`` on the CPU.

``python _torch_dp_programs_worker.py MODE OUT``, started with
``WORLD_SIZE``/``RANK``/``MASTER_ADDR``/``MASTER_PORT`` in the environment:

- ``reduce``: ``DataParallel.reduce_metrics`` over the world, three calls
  on one key set and one on another: the masks it uploads, and its outputs
  beside every rank's input vector;
- ``pairs`` / ``pairs_fused``: the tiny SAC slice through ``train_rl`` on a
  ``DeviceReplayMemory`` fed by rank 0's rollout (4 envs in 2 groups, 8 env
  steps and 4 updates per cycle, interleaved; ``pairs_fused`` with
  ``act_fused_updates``): every update program the rank runs, as
  ``(kind, n, len(replay))``, and its final parameters.

Writes its results to ``OUT``.  Imports nothing of JAX.
"""

import os
import os.path as osp
import sys

import torch

sys.path.insert(0, osp.dirname(osp.abspath(__file__)))

from _torch_dp_worker import SLICE_CONFIG, TINY, agent_cfg_of  # noqa: E402

from pointcloud_rl_torch.parallel import init_distributed  # noqa: E402
from pointcloud_rl_torch.parallel.mesh import DataParallel  # noqa: E402

torch.set_num_threads(1)

KEYS = ([False, True, False], [True, False])  # two metric key sets: which entries are maxed


def reduce_metrics() -> dict:
    rank, size = torch.distributed.get_rank(), torch.distributed.get_world_size()
    dp = DataParallel(rank, size, distributed=True)
    uploads, as_tensor = [], torch.as_tensor

    def counted(*args, **kwargs):
        uploads.append(args[0])
        return as_tensor(*args, **kwargs)

    torch.as_tensor = counted
    calls = []
    for i, maxed in enumerate((KEYS[0], KEYS[0], KEYS[0], KEYS[1])):
        values = torch.arange(len(maxed), dtype=torch.float32) * (rank + 1) + i
        calls.append({"maxed": maxed, "values": values, "out": dp.reduce_metrics(values, maxed)})
    torch.as_tensor = as_tensor
    return {"calls": calls, "uploads": uploads, "masks": len(dp._masks)}


def pairs(fused: bool, work_dir: str) -> dict:
    from pointcloud_rl_torch.algorithms import build_agent
    from pointcloud_rl_torch.apis.train_rl import train_rl
    from pointcloud_rl_torch.config import Config
    from pointcloud_rl_torch.env import build_replay
    from pointcloud_rl_torch.env.rollout import Rollout
    from pointcloud_rl_torch.parallel import replicate_rollout, setup_data_parallel

    cfg = Config.fromfile(SLICE_CONFIG)
    cfg.merge_from_dict(TINY)
    agent = build_agent(agent_cfg_of(SLICE_CONFIG, {}))
    replay = build_replay(dict(type="DeviceReplayMemory", capacity=200), dict(seed=0), device="cpu")
    setup_data_parallel(agent, torch.distributed.get_world_size(), replay=replay)
    lead = torch.distributed.get_rank() == 0
    rollout = replicate_rollout(Rollout(env_cfg=dict(cfg["env_cfg"]), num_procs=4, base_seed=0, vec_backend="thread",
                                        pipeline_groups=2, device="cpu") if lead else None)
    programs, program = [], agent._program

    def recorded(kind, n, body, inputs=None, memory=None):
        programs.append((kind, n, len(memory)))
        return program(kind, n, body, inputs, memory)

    agent._program = recorded
    try:
        train_rl(agent, rollout, None, replay, work_dir=work_dir, total_steps=8 + 3 * 8, warm_steps=8, n_steps=8,
                 n_updates=4, n_log=16, n_eval=-1, n_checkpoint=-1, act_fused_updates=fused)
    finally:
        rollout.close()
    state = agent.state_dict()
    return {"programs": programs, "model": state["model"], "target": state["target"],
            "log_alpha": state["log_alpha"], "updates": agent.updates}


def main(mode: str, out: str) -> None:
    if not init_distributed(device="cpu"):
        raise RuntimeError("needs a world: WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT")
    try:
        if mode == "reduce":
            result = reduce_metrics()
        else:
            result = pairs(mode == "pairs_fused", osp.join(osp.dirname(out), f"wd{torch.distributed.get_rank()}"))
        torch.save(result, out)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
