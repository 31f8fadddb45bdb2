"""The port's spans: named host intervals on the profiler's clock.

``with span(name):`` marks the host's work at a layer boundary.  With no
``torch.profiler`` session running it costs a test of the profiler's
module flag (``torch.autograd.profiler._is_profiler_enabled``; none where
torch is not imported, as in the env workers, which this module leaves
without torch) and enters a shared null context.  Inside a session (the
benchmark's ``--trace 1``, ``run_rl --profile N``) it opens
``torch.profiler.record_function(name)``, so the span's start, end and
nesting land in the session's Chrome trace beside the kernels, on the
same clock, and each idle stretch of the card can be put down to the
innermost span open over it.

The spans of ``TIMED`` also add their host seconds to ``seconds``, with or
without a session: the rollout's log keys read them (``env/rollout.py``).
``seconds`` only grows; a reader takes the difference of two reads, as
with the counters.

The names are the constants below, and ``NAMES`` holds every one.  No span
opens inside the body of a captured update program (it would run only at
the program's eager run and its capture, never at a replay).

``StreamClock`` times the work enqueued inside its blocks: on a card with
CUDA events on the current stream (``train_rl``'s ``update_time``).

The counters live here too.  A module that counts what it launches
registers a dict of zeros with ``counter(name, keys)`` and adds to it in
place; ``COUNTERS`` holds every one by its name, which is its key in
``run_summary.json``.  A captured update program (``algorithms/graphs.py``)
takes back what its capture counted and adds it again on every replay, by
key (``counts``, ``add_counts``), so no key is in two counters.  A reader
takes the difference of two reads; ``reset_counters`` zeroes them in place.
"""

from __future__ import annotations

import functools
import sys
import time
from typing import Dict, List, Optional, Sequence

TRAIN_CYCLE = "train.cycle"  # one turn of train_rl's loop; its args are the cycle's index
TRAIN_UPDATES = "train.updates"  # one update dispatch of train_rl
SAC_UPDATE = "sac.update"  # the host side of one update, or of one scanned program
REPLAY_SAMPLE = "replay.sample"  # a host replay's gather of a batch
GRAPHS_UPLOAD = "graphs.upload"  # host inputs copied into a program's static inputs
GRAPHS_REPLAY = "graphs.replay"  # a program's graph replay and the clones of its outputs
GRAPHS_EAGER = "graphs.eager"  # a program's eager first run
GRAPHS_CAPTURE = "graphs.capture"  # a program's capture
ACT_DISPATCH = "forward_async.dispatch"  # the act's host obs, upload and launches
ACT_WAIT = "forward_async.wait"  # waiting for an act's actions
OBS_FUSE = "obs_fuse"  # the fusion of raw renders into point clouds on the device
ENV_WAIT = "rollout.env_wait"  # waiting for the env workers' step (and fusing its obs)
ROLLOUT_PUSH = "rollout.push"  # the rollout's pushes into the replay
ROLLOUT_COLLECT = "rollout.collect"  # one collection call; its self time is the rollout's own bookkeeping

NAMES = (TRAIN_CYCLE, TRAIN_UPDATES, SAC_UPDATE, REPLAY_SAMPLE, GRAPHS_UPLOAD, GRAPHS_REPLAY, GRAPHS_EAGER,
         GRAPHS_CAPTURE, ACT_DISPATCH, ACT_WAIT, OBS_FUSE, ENV_WAIT, ROLLOUT_PUSH, ROLLOUT_COLLECT)
TIMED = (ACT_DISPATCH, ACT_WAIT, ENV_WAIT, ROLLOUT_PUSH)

seconds: Dict[str, float] = dict.fromkeys(TIMED, 0.0)  # host seconds of the timed spans, since import


class _Null:
    """The shared context of a span outside a session (cheaper to enter than ``contextlib.nullcontext``)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_NULL = _Null()
_modules = sys.modules
_PROFILER = "torch.autograd.profiler"


class _Clocked:
    """A timed span outside a profiler session: its host seconds."""

    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        seconds[self.name] += time.perf_counter() - self.t0


class _Recorded:
    """A span inside a profiler session: a ``record_function`` (and its host
    seconds, where the span is timed)."""

    __slots__ = ("name", "rf", "t0")

    def __init__(self, profiler, name: str, args: Optional[str]):
        self.name = name
        self.rf = profiler.record_function(name, args)

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.rf.__enter__()

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        if self.name in seconds:
            seconds[self.name] += time.perf_counter() - self.t0


def span(name: str, args: Optional[str] = None):
    """The context of the span ``name`` (one of ``NAMES``); ``args`` is
    handed to ``record_function``."""
    profiler = _modules.get(_PROFILER)
    if profiler is not None and profiler._is_profiler_enabled:
        return _Recorded(profiler, name, args)
    if name in seconds:
        return _Clocked(name)
    return _NULL


class StreamClock:
    """The seconds the work enqueued inside ``with clock:`` blocks takes.

    On a card a block's edges are a pair of timing events recorded on the
    current stream, and ``take()`` reads the pairs: call it once the stream
    has passed the last block (after a fetch from the stream), so that the
    read waits for nothing.  Elsewhere the blocks' host seconds."""

    def __init__(self, device):
        import torch

        cuda = torch.device(device).type == "cuda"
        self._event = functools.partial(torch.cuda.Event, enable_timing=True) if cuda else None
        self._pairs: List[list] = []
        self._host = 0.0
        self._t0 = 0.0

    def __enter__(self):
        if self._event is not None:
            start = self._event()
            start.record()
            self._pairs.append([start, None])
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._event is not None:
            end = self._event()
            end.record()
            self._pairs[-1][1] = end
        else:
            self._host += time.perf_counter() - self._t0

    def take(self) -> float:
        """The seconds of the blocks since the last ``take``."""
        total = self._host
        if self._pairs:
            self._pairs[-1][1].synchronize()  # passed already where the caller fetched from the stream
            total += sum(a.elapsed_time(b) for a, b in self._pairs) / 1e3
        self._pairs.clear()
        self._host = 0.0
        return total


# the registered counters by name, each a dict of counts by key
COUNTERS: Dict[str, Dict[str, int]] = {}


def counter(name: str, keys: Sequence[str]) -> Dict[str, int]:
    """Register the counter ``name`` and return its dict of zeros by ``keys``.

    Refuses a name already registered, and a key that another counter
    holds: a replay adds each count back by its key alone."""
    if name in COUNTERS:
        raise ValueError(f"the counter {name!r} is registered already")
    held = sorted(set(keys) & set(counts()))
    if held:
        raise ValueError(f"the counter {name!r}: another counter holds the keys {held}")
    COUNTERS[name] = dict.fromkeys(keys, 0)
    return COUNTERS[name]


def counts() -> Dict[str, int]:
    """Every registered count by its key, in one dict (a copy)."""
    return {key: n for c in COUNTERS.values() for key, n in c.items()}


def add_counts(added: Dict[str, int]) -> None:
    """Add ``added`` to the registered counts by key (a negative count takes back)."""
    for key, n in added.items():
        next(c for c in COUNTERS.values() if key in c)[key] += n


def reset_counters() -> None:
    """Zero every registered count, in place: readers hold the dicts."""
    for c in COUNTERS.values():
        for key in c:
            c[key] = 0
