"""Process groups, lead gating and host-side reductions over ranks.

Port of ``pointcloud_rl_tpu/parallel/distributed.py`` onto
``torch.distributed``: one process per GPU (or per CPU rank) joins a
process group from the launcher's environment (``MASTER_ADDR`` /
``MASTER_PORT``, ``WORLD_SIZE`` / ``RANK``, or SLURM's), NCCL for CUDA and
gloo for the CPU.  ``allreduce_stats`` reduces a flat dict of host scalars
in one collective; ``DistVar`` is a one-sided named counter on the process
group's ``TCPStore``, so a rank may add to it or read it any number of
times without its peers entering a collective.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Dict, Optional

import torch
import torch.distributed as dist

# While the lead alone collects, evaluates or saves a checkpoint, the other
# ranks wait inside their next collective: its timeout bounds that work,
# not only a hang (the defaults are 10 minutes for NCCL, 30 for gloo).
COLLECTIVE_TIMEOUT = timedelta(hours=2)
_OPS = {"mean": dist.ReduceOp.SUM, "sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def init_distributed(device: str = "cuda", init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None) -> bool:
    """Join the process group the arguments or the launcher's environment
    describe: NCCL for ``device="cuda"`` (which raises without a visible
    GPU), gloo for ``device="cpu"``.  Joins nothing and returns False for a
    world of one."""
    if init_method is None and os.environ.get("MASTER_ADDR"):
        init_method = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '12355')}"
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", os.environ.get("SLURM_NTASKS", "1")))
    if rank is None:
        rank = int(os.environ.get("RANK", os.environ.get("SLURM_PROCID", "0")))
    if init_method is None or world_size <= 1:
        return False
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_distributed(device='cuda'): torch.cuda.is_available() is false "
                           "(pass device='cpu' for gloo ranks on the CPU)")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    dist.init_process_group("nccl" if device == "cuda" else "gloo", init_method=init_method, world_size=world_size,
                            rank=rank, timeout=COLLECTIVE_TIMEOUT)
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_lead_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def collective_device() -> torch.device:
    """Where a host value goes for a collective: NCCL reduces CUDA tensors
    only (on the rank's current device), gloo CPU ones."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allreduce_stats(stats: Dict[str, float], op: str = "mean") -> Dict[str, float]:
    """Reduce a flat dict of scalars over the ranks (every rank passes the
    same keys): one ``all_reduce`` of a float64 vector over the sorted keys.
    The identity in a world of one."""
    if world_size() == 1:
        return stats
    keys = sorted(stats)
    vec = torch.tensor([float(stats[k]) for k in keys], dtype=torch.float64, device=collective_device())
    dist.all_reduce(vec, op=_OPS[op])  # KeyError for an unknown op, as in the JAX package
    if op == "mean":
        vec /= dist.get_world_size()
    return dict(zip(keys, vec.tolist()))


class DistVar:
    """A named counter every rank may add to and read, one-sided: ``add``
    is ``store.add(key, value)`` on the process group's ``TCPStore`` and
    ``get`` is ``store.add(key, 0)``, so no peer has to take part.

    A per-name generation counter namespaces the keys, so a new DistVar of
    a name starts at zero although store keys persist; every rank makes its
    vars of a name in the same order, so the generations agree without a
    sync.  Outside a process group it counts locally."""

    _generations: Dict[str, int] = {}

    def __init__(self, name: str):
        gen = DistVar._generations.get(name, 0)
        DistVar._generations[name] = gen + 1
        self.key = f"pcrl/distvar/{name}/{gen}"
        self._local = 0
        self._store = dist.distributed_c10d._get_default_store() if dist.is_initialized() else None

    def add(self, value: int = 1) -> None:
        if self._store is None:
            self._local += int(value)
        else:
            self._store.add(self.key, int(value))

    def get(self) -> int:
        if self._store is None:
            return self._local
        return int(self._store.add(self.key, 0))
