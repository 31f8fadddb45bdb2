"""``run_rl --num-devices N`` with every rank's updates recorded.

``python _torch_spawned_ranks.py <run_rl arguments>`` runs ``run_rl.main``.
At import it wraps ``run_rl.train_rl``: each rank records its
``update_parameters_scan`` calls as ``("scan", len(replay), n)`` and, after
training, writes them with its parameters to ``$PCRL_RANKS_OUT/rank<R>.pt``.
The ranks that ``run_rl`` spawns import this script as their main module,
so the wrapper is in place in every rank.

Imports nothing of JAX.
"""

import os
import os.path as osp
import sys

import torch

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from pointcloud_rl_torch.apis import run_rl  # noqa: E402

_train_rl = run_rl.train_rl


def recording(**kwargs):
    agent = kwargs["agent"]
    scans, scan = [], agent.update_parameters_scan

    def recorded(memory, n):
        scans.append(("scan", len(memory), n))
        return scan(memory, n)

    agent.update_parameters_scan = recorded
    out = _train_rl(**kwargs)
    state = agent.state_dict()
    torch.save({"scans": scans, "model": state["model"], "target": state["target"], "log_alpha": state["log_alpha"],
                "updates": state["updates"], "grad_steps": out["grad_steps"]},
               osp.join(os.environ["PCRL_RANKS_OUT"], f"rank{os.environ.get('RANK', '0')}.pt"))
    return out


run_rl.train_rl = recording

if __name__ == "__main__":
    run_rl.main(sys.argv[1:])
