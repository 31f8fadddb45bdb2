"""Data parallelism over ``torch.distributed`` ranks, one process per GPU.

Port of ``pointcloud_rl_tpu/parallel/mesh.py``.  The JAX package jits the
same update with the train state replicated and the batch sharded on a
``data`` mesh axis, and XLA inserts the gradient all-reduce.  Here each
rank holds the whole train state and a replica of the replay; every rank
samples the same GLOBAL batch (the replicas get the same seed and the same
pushes), prepares it, and keeps its rows ``[r*B/N, (r+1)*B/N)``; each
optimizer step all-reduces its gradients as one flat mean before the
global-norm clip, so every rank takes the same step and the parameters
stay bitwise equal across ranks.  There is no DDP wrapper: SAC's three
optimizers, target networks, shared encoder and reused features need a
collective exactly where an optimizer steps, as in the JAX package.

The update's random draws come from the agent's generator, in the same
state on every rank: inside ``sharded_draws`` a draw over the batch axis
(``utils.draws.draw_rows``) draws the global batch's rows and keeps this
rank's, so the N-rank update equals the 1-rank update with the noise on,
up to the order of the gradient sums.

One rank per host collects: the host lead's rollout pushes into its
replay, and each collection's pushes are broadcast to the other ranks of
its host, and they make the same pushes into their replicas
(``replicate_rollout``).  On one host (``run_rl --num-devices``)
that is rank 0 for every rank.  Across hosts (``distributed.setup_hosts``)
each host collects into its own replicas, as each of the JAX package's
processes does: rank r of N then trains on rows ``[r*B/N, (r+1)*B/N)`` of
the batch its own replica gives, which is the JAX package's update of a
batch sharded over a mesh that spans the hosts, each device's rows taken
from its own process's batch.  The hosts are seeded alike, so their
replicas stay equal until the straggler vote of a full-episode rollout
cuts a slow host short.  That costs N times the replay memory, as the JAX
package's replicated storage does.  While the lead collects, evaluates or
saves, the other ranks wait in their next collective
(``distributed.COLLECTIVE_TIMEOUT``).

Updates interleaved with the collection run in lockstep: before each
chunk of updates the lead runs inside its collection, it tells its host
"the pushes so far, then n updates", and each other rank of the host
makes those pushes and runs the same n updates on its replica, so every
rank's chunk samples the buffer the lead's samples, and their gradient
all-reduces pair up.

An agent that is no rank of a world holds ``DataParallel()``, a world of
one without a process group, where every method is the identity.  The
collectives of an NCCL rank are kernels on the card, which a CUDA graph
captures (``capturable``; ``algorithms/graphs.py``): neither the gradient
all-reduce nor the metric reduce reads anything from the host.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.draws import split_draws
from .distributed import host_broadcast, is_host_lead
from ..utils.stats import EpisodicStatistics
from ..utils.tree_ops import tree_map


class DataParallel:
    """This rank's place in a data-parallel world and its collectives.

    Without a process group (``distributed=False``, the default world of
    one) every collective is the identity; in one, even of one rank, the
    collectives run."""

    def __init__(self, rank: int = 0, size: int = 1, distributed: bool = False):
        self.rank, self.size, self.distributed = rank, size, distributed
        self._masks: Dict[Tuple, torch.Tensor] = {}  # reduce_metrics' max-or-mean masks, per device and key set

    @property
    def is_lead(self) -> bool:
        return self.rank == 0

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture this rank's collectives: outside
        a process group (there are none) and over NCCL, whose collectives are
        kernels on the card; not over gloo, whose collectives run on the
        host."""
        return not self.distributed or dist.get_backend() == "nccl"

    # ------------------------------------------------------------- batches
    def shard(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's rows of a prepared global batch.  A window batch also
        gets ``valid_frames``: the global batch's valid frames over the world
        size, the normaliser that makes the mean of the ranks' losses the
        global loss."""
        if self.size == 1:
            return batch
        rows = int(batch["rewards"].shape[0])
        if rows % self.size:
            raise ValueError(f"the global batch of {rows} rows does not split over {self.size} ranks")
        per = rows // self.size
        out = tree_map(lambda x: x[self.rank * per:(self.rank + 1) * per], batch)
        if "is_valid" in batch:
            out["valid_frames"] = batch["is_valid"].float().sum() / self.size
        return out

    def sharded_draws(self):
        """A context in which batch-axis draws (``utils.draws.draw_rows``)
        draw the global batch's rows and keep this rank's."""
        return split_draws(self.rank, self.size)

    # --------------------------------------------------------- collectives
    def allreduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The mean of ``grads`` over the ranks: ONE all-reduce of a flat
        float32 buffer that holds them all."""
        if not self.distributed or not grads:
            return grads
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        dist.all_reduce(flat)
        flat /= self.size
        out, at = [], 0
        for g in grads:
            out.append(flat[at:at + g.numel()].view(g.shape).to(g.dtype))
            at += g.numel()
        return out

    def reduce_metrics(self, values: torch.Tensor, maxed: Sequence[bool]) -> torch.Tensor:
        """Per-update metrics over the ranks in one collective: the mean,
        or the max where ``maxed``.  Each rank's vector goes into its row of
        a ``[size, K]`` zero buffer, and a sum all-reduce gathers them."""
        if not self.distributed:
            return values
        rows = torch.zeros((self.size,) + tuple(values.shape), dtype=torch.float32, device=values.device)
        rows[self.rank] = values.float()
        dist.all_reduce(rows)
        return torch.where(self._mask(values.device, maxed), rows.max(dim=0).values, rows.mean(dim=0))

    def _mask(self, device: torch.device, maxed: Sequence[bool]) -> torch.Tensor:
        """``maxed`` as a bool tensor on ``device``, uploaded at its first use
        (an update program's eager run) and kept: a capture may not copy from
        the host."""
        key = (device, tuple(bool(m) for m in maxed))
        if key not in self._masks:
            self._masks[key] = torch.as_tensor(key[1], dtype=torch.bool, device=device)
        return self._masks[key]


def setup_data_parallel(agent, world: int, replay=None) -> DataParallel:
    """Make ``agent`` one of ``world`` data-parallel ranks of the process
    group (``init_distributed``); without a group only a world of one.
    The agent's optimizers then all-reduce their gradients, its update
    keeps this rank's rows of the global batch, and ``replay`` (a
    ``DeviceReplayMemory``) is placed on the agent's device."""
    size = dist.get_world_size() if dist.is_initialized() else 1
    if size != world:
        raise RuntimeError(f"Need {world} ranks, have {size}"
                           + ("" if dist.is_initialized() else " (no process group: call init_distributed)"))
    if agent.batch_size % world:
        raise ValueError(f"agent_cfg.batch_size={agent.batch_size} does not split over {world} ranks")
    dp = DataParallel(dist.get_rank() if dist.is_initialized() else 0, size, distributed=dist.is_initialized())
    agent.set_data_parallel(dp)
    if replay is not None and hasattr(replay, "place_on"):
        replay.place_on(agent.device)
    return dp


# ------------------------------------------------------------ collection
def _portable(items: Dict[str, Any]) -> Dict[str, Any]:
    """A pushed batch as it travels to the other ranks: without ``infos``
    (no replay stores them), numpy leaves copied (a rollout may reuse its
    buffers), tensors on the CPU."""
    items = {k: v for k, v in items.items() if k != "infos"}

    def one(x):
        return x.detach().cpu() if isinstance(x, torch.Tensor) else np.array(x, copy=True)

    return tree_map(one, items)


class _PushRecorder:
    """The lead's replay, recording each push the rollout makes."""

    _PUSHES = ("push_batch", "cache_trajectories", "push_cached_trajectories")

    def __init__(self, replay):
        self.replay = replay
        self.calls: List[tuple] = []

    def __len__(self) -> int:
        return len(self.replay)

    def __getattr__(self, name):
        attr = getattr(self.replay, name)
        if name not in self._PUSHES:
            return attr

        def record(*args, **kwargs):
            self.calls.append((name, tuple(_portable(a) if isinstance(a, dict) else a for a in args), kwargs))
            return attr(*args, **kwargs)

        return record


class LeadRollout:
    """A host lead's rollout: collects as usual and sends its host what the
    other ranks must do, in order: the pushes made before each chunk of
    updates it runs inside the collection (``announce_updates``), then the
    rest of the pushes."""

    def __init__(self, rollout):
        self.rollout = rollout
        self._recorder, self._broadcast_s = None, 0.0
        host_broadcast((rollout.num_envs, rollout.pipeline_groups))

    def __getattr__(self, name):
        return getattr(self.rollout, name)

    @property
    def episode_stats(self):
        return self.rollout.episode_stats

    @episode_stats.setter
    def episode_stats(self, value):
        self.rollout.episode_stats = value

    def _send(self, n) -> None:
        """Broadcast (the pushes recorded since the last message, ``n``)."""
        calls = []
        if self._recorder is not None:
            calls, self._recorder.calls = self._recorder.calls, []
        t0 = time.monotonic()
        host_broadcast((calls, n))
        self._broadcast_s += time.monotonic() - t0

    def announce_updates(self, n: int) -> None:
        """Call just before running ``n`` updates inside a collection: the
        host's other ranks make the pushes so far and run ``n`` updates too."""
        self._send(n)

    def forward_with_policy(self, pi, num: int, replay=None, **kwargs) -> Dict[str, Any]:
        self._recorder = _PushRecorder(replay) if replay is not None else None
        self._broadcast_s = 0.0
        out = self.rollout.forward_with_policy(pi, num, self._recorder, **kwargs) or {}
        self._send(None)
        self._recorder = None
        out.setdefault("_stats", {})["broadcast_time"] = self._broadcast_s
        return out


class ReplicaRollout:
    """Another rank's rollout: follows its host lead's collection, making
    the lead's pushes into its replica and running ``update_hook(n)`` where
    the lead ran ``n`` updates."""

    def __init__(self):
        self.num_envs, self.pipeline_groups = host_broadcast(None)
        self.episode_stats = EpisodicStatistics(self.num_envs)  # stays empty: the host lead's rollout collects

    def forward_with_policy(self, pi, num: int, replay=None, update_hook=None, **kwargs) -> Dict[str, Any]:
        t0, updates_s = time.monotonic(), 0.0
        while True:
            calls, n = host_broadcast(None)
            for name, args, kw in calls:
                getattr(replay, name)(*args, **kw)
            if n is None:
                break
            if update_hook is None:
                raise RuntimeError(f"the host lead ran {n} updates inside its collection, and this rank has no "
                                   "update hook to follow it")
            t1 = time.monotonic()
            update_hook(n)
            updates_s += time.monotonic() - t1
        return {"_stats": {"broadcast_time": time.monotonic() - t0 - updates_s}}

    def close(self) -> None:
        pass


def replicate_rollout(rollout):
    """Every rank's view of its host's collection: the host lead's
    ``rollout`` wrapped to broadcast its pushes, a ``ReplicaRollout`` on
    the host's other ranks (which pass None).  Call on every rank, in the
    same order."""
    if is_host_lead():
        if rollout is None:
            raise ValueError("a host lead needs the rollout")
        return LeadRollout(rollout)
    return ReplicaRollout()
