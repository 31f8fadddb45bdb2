"""Process groups, lead gating and host-side reductions over ranks.

Port of ``pointcloud_rl_tpu/parallel/distributed.py`` onto
``torch.distributed``: one process per GPU (or per CPU rank) joins a
process group from the launcher's environment (``MASTER_ADDR`` /
``MASTER_PORT``, ``WORLD_SIZE`` / ``RANK``, or SLURM's), NCCL for CUDA and
gloo for the CPU.  ``allreduce_stats`` reduces a flat dict of host scalars
in one collective; ``DistVar`` is a one-sided named counter on the process
group's ``TCPStore``, so a rank may add to it or read it any number of
times without its peers entering a collective.

A world launched from outside (torchrun, SLURM) spans hosts:
``setup_hosts`` reads each rank's host from the launcher's environment,
publishes it on the store and makes one process group per host, so each host lead can collect and broadcast its pushes to the ranks
of its host alone (``parallel.mesh``); ``mean_over_hosts`` averages the
host leads' episode statistics.  Without ``setup_hosts`` the world is one
host, as ``run_rl --num-devices`` spawns it.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Dict, List, Optional, Tuple

import numpy as np
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


# ------------------------------------------------------------------ hosts
class HostLayout:
    """The world's hosts, each a list of global ranks in ascending order
    (its lead, the lowest, first), in the order of their leads; ``index``
    is this rank's host and ``groups[h]`` the process group of host h
    (None for a host of one rank, and for the whole world when it is one
    host)."""

    def __init__(self, hosts: List[List[int]], index: int, groups: List[Optional[object]]):
        self.hosts, self.index, self.groups = hosts, index, groups


# The layout of the process group, which is itself the process's global
# state in torch.distributed; ``clear_hosts`` forgets it with the group.
_LAYOUT: Optional[HostLayout] = None


def launcher_host(rank: int) -> Tuple[int, Optional[int]]:
    """(host key, ranks the launcher put on that host) of this process:
    torchrun's ``GROUP_RANK`` and ``LOCAL_WORLD_SIZE``, else SLURM's
    ``SLURM_NODEID`` and ``SLURM_NTASKS_PER_NODE`` (where it is one
    number), else a host of its own: one process per host, as the JAX
    package runs."""
    env = os.environ
    for host, local, size in (("GROUP_RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"),
                              ("SLURM_NODEID", "SLURM_LOCALID", "SLURM_NTASKS_PER_NODE")):
        if host in env and local in env:
            per_host = env.get(size, "")
            return int(env[host]), int(per_host) if per_host.isdigit() else None
    return rank, 1


def local_rank() -> int:
    """This process's rank on its host (which GPU it takes), from the
    launcher's environment; 0 without one."""
    return int(os.environ.get("LOCAL_RANK", os.environ.get("SLURM_LOCALID", "0")))


def setup_hosts() -> HostLayout:
    """Lay the process group's ranks out over hosts (``launcher_host``) and
    make each host's process group.  Every rank calls it once, after
    joining: each publishes its host on the process group's store and
    reads every other's (no collective, so no device is touched), then
    calls ``new_group`` for every host of more than one rank, in the same
    order, the ranks outside a group too.  A host's lead is its lowest
    global rank, so rank 0 leads host 0."""
    global _LAYOUT
    rank, size = dist.get_rank(), dist.get_world_size()
    store = dist.distributed_c10d._get_default_store()
    key, per_host = launcher_host(rank)
    store.set(f"pcrl/hosts/{rank}", str(key))
    members: Dict[int, List[int]] = {}
    for r in range(size):
        members.setdefault(int(store.get(f"pcrl/hosts/{r}")), []).append(r)
    hosts = sorted(members.values(), key=min)
    if per_host is not None and per_host != len(members[key]):
        raise RuntimeError(f"the launcher puts {per_host} ranks on this host (key {key}), "
                           f"{len(members[key])} joined it: {members[key]}")
    index = next(i for i, h in enumerate(hosts) if rank in h)
    groups: List[Optional[object]] = [None] * len(hosts)
    if len(hosts) > 1:
        for i, h in enumerate(hosts):
            if len(h) > 1:
                groups[i] = dist.new_group(h)
    _LAYOUT = HostLayout(hosts, index, groups)
    return _LAYOUT


def clear_hosts() -> None:
    """Forget the layout (the process group it was made for is gone)."""
    global _LAYOUT
    _LAYOUT = None


def host_layout() -> HostLayout:
    """The layout ``setup_hosts`` made; without one, the world is one host."""
    if dist.is_initialized() and _LAYOUT is not None:
        return _LAYOUT
    return HostLayout([list(range(world_size()))], 0, [None])  # one host: the world


def num_hosts() -> int:
    return len(host_layout().hosts)


def host_index() -> int:
    return host_layout().index


def host_ranks() -> List[int]:
    """The global ranks of this rank's host, its lead first."""
    layout = host_layout()
    return layout.hosts[layout.index]


def is_host_lead() -> bool:
    return not dist.is_initialized() or dist.get_rank() == host_ranks()[0]


def host_broadcast(obj):
    """The host lead's ``obj`` on every rank of its host (pickled, inside
    the host's process group, from the lead's global rank)."""
    ranks = host_ranks()
    if not dist.is_initialized() or len(ranks) == 1:
        return obj
    layout = host_layout()
    box = [obj]
    dist.broadcast_object_list(box, src=ranks[0], group=layout.groups[layout.index])
    return box[0]


def per_host(value) -> list:
    """Each host lead's ``value``, in host order (a collective of every
    rank)."""
    if world_size() == 1:
        return [value]
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, value)
    return [gathered[h[0]] for h in host_layout().hosts]


def mean_over_hosts(stats: Dict[str, float]) -> Dict[str, float]:
    """Episode statistics over hosts: for each key, the mean over the host
    leads that report it (the other ranks enter with nothing).  Equals the
    JAX package's ``allreduce_stats(op="mean")`` over hosts where every host
    reports the same keys; where the key sets differ, a key is averaged
    over the hosts that have it, where the JAX package's collective would
    fail or hang.  Every rank calls it; with one host it is the lead's
    statistics."""
    if world_size() == 1:
        return stats
    reports = per_host(dict(stats) if is_host_lead() else {})
    keys = dict.fromkeys(k for report in reports for k in report)
    return {k: float(np.mean([r[k] for r in reports if k in r])) for k in keys}
