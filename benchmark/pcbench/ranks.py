"""A cell on several cards: one process per card, each a data-parallel rank of the port.

``launch(world, fn, args, device)`` spawns ``world`` processes.  Rank r
takes card r (``device`` ``"cuda"``: NCCL) or the CPU (``"cpu"``: gloo, for
the benchmark's own tests), joins the process group through the port's
``parallel.init_distributed`` on a free local port, runs ``fn(*args)`` and
sends back what it returns.  ``launch`` returns the values in rank order
once every rank has ended.  A rank that raises, or ends without a value,
ends the others: ``launch`` then raises ``RankFailed`` with its error.  No
process it started is left running, also where ``launch`` itself is ended
(SIGTERM raises ``SystemExit`` in it while it waits).

Inside a rank, ``WindowEnd`` is how the ranks agree on the window's
last round without a collective on the host: rank 0 decides by its clock
and posts the round on the process group's store, and the others read it
there between rounds.
"""

from __future__ import annotations

import multiprocessing
import queue
import signal
import socket
import traceback
from typing import Any, Callable, List, Optional, Sequence

STOP_KEY = "pcbench/last_round"
JOIN_S = 60.0  # how long an ended rank's process may take to exit


class RankFailed(RuntimeError):
    """A rank raised, or its process ended without a value."""


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return int(sock.getsockname()[1])


def _entry(rank: int, world: int, port: int, device: str, fn: Callable, args: Sequence, out) -> None:
    try:
        import torch
        import torch.distributed as dist

        from pointcloud_rl_torch.parallel.distributed import init_distributed

        if device == "cuda":
            torch.cuda.set_device(rank)
        init_distributed(device, init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)
        try:
            value = fn(*args)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise
    out.put((rank, True, value))


def _exit(signum, frame):
    raise SystemExit(128 + signum)


def launch(world: int, fn: Callable, args: Sequence, device: str) -> List[Any]:
    """``fn(*args)`` on ``world`` ranks; their values in rank order."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(r, world, port, device, fn, tuple(args), out), name=f"rank{r}")
             for r in range(world)]
    values: dict = {}
    failed: Optional[str] = None
    prev = signal.signal(signal.SIGTERM, _exit)
    try:
        for p in procs:
            p.start()
        while len(values) < world and failed is None:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in values and p.exitcode is not None]
                if dead:
                    failed = f"rank {dead[0]} ended (exit code {procs[dead[0]].exitcode}) without a result"
                continue
            if ok:
                values[rank] = value
            else:
                failed = f"rank {rank} failed:\n{value}"
    finally:
        signal.signal(signal.SIGTERM, prev)
        for p in procs:
            if len(values) < world and p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is None:
                continue
            p.join(JOIN_S)
            if p.is_alive():
                p.kill()
                p.join()
    if failed is not None:
        raise RankFailed(failed)
    return [values[r] for r in range(world)]


class WindowEnd:
    """When the window's last round has been launched, agreed by every rank.

    A rank's rounds all-reduce on the card, so no rank's host can run more
    than ``in_flight + 1`` rounds ahead of rank 0's.  Rank 0 ends the window
    by its clock, ``margin`` (``in_flight + 2``) rounds past the round at
    which its time was up, and posts that round on the store; the others
    look for it there after each round.  In a world of one the clock alone
    decides.  Each window of a process has a key of its own on the store
    (every rank makes its windows in the same order)."""

    made = 0  # windows made in this process

    def __init__(self, in_flight: int):
        import torch.distributed as dist

        self.world = dist.get_world_size() if dist.is_initialized() else 1
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.store = dist.distributed_c10d._get_default_store() if self.world > 1 else None
        self.margin = int(in_flight) + 2 if self.world > 1 else 0
        self.last: Optional[int] = None
        self.key = f"{STOP_KEY}/{WindowEnd.made}"
        WindowEnd.made += 1

    def reached(self, rounds: int, time_up: bool) -> bool:
        """After launching round ``rounds`` (counted from 1): whether it is the window's last."""
        if self.last is None:
            if self.rank == 0:
                if time_up:
                    self.last = rounds + self.margin
                    if self.store is not None:
                        self.store.set(self.key, str(self.last))
            elif self.store.check([self.key]):
                self.last = int(self.store.get(self.key))
        return self.last is not None and rounds >= self.last
