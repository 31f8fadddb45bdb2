"""The agent's update programs as captured CUDA graphs.

Port of the JAX package's compiled update programs
(``pointcloud_rl_tpu/algorithms/sac.py``: ``_update_jit``,
``_build_storage_update``, ``_build_storage_update_scan``,
``_build_act_update_scan``).  Where the JAX package jits a program, the
port captures a CUDA graph of its eager step and replays it: one launch
for a whole update, or for a cycle's updates, in place of the several
hundred kernel launches the eager step dispatches from the host.

A program is one of three kinds:

- ``"storage"``: ``n`` updates, each sampling a ``DeviceReplayMemory`` on
  the device (against its ``device_size``) and stepping;
- ``"batch"``: one update on a host batch, which is copied into the
  program's static input tensors before each replay;
- ``"act"``: ``n`` storage updates, then the explore act on observations
  copied into the program's static inputs.

The actor and target gates (``updates % interval``) are host branches of
the eager step, so a program is captured for each gate phase
(``updates % lcm(actor_update_interval, target_update_interval)``) at
which it runs.  The first call of a program runs its body eagerly, on the
capture stream: that creates the optimizers' state and whatever the body
makes once per device, so that nothing is uploaded from the host inside a
capture; the second call captures it (nothing runs) and replays it; later
calls replay.  A capture does not execute, but its Python runs: the
agent's update counter and metric keys are put back after it, and the
fused PointNet kernel's launch counts captured in it are taken back and
added again on every replay, which is where those kernels launch.  Every
generator the body draws from (the agent's, its act generator, the
replay's) is registered with the graph, so a replay draws what the eager
step would and advances the generators as it would.  Returned tensors
are copies the caller owns: the next replay overwrites the outputs.

A failed capture raises; nothing falls back to the eager step.  The
programs are dropped (``invalidate``) when the tensors they read are
replaced: the agent's ``load_state_dict`` and ``load_params``, and a move
of the replay's storage (``storage_version``).

A call opens the spans of ``utils/trace.py`` around its host work, never
inside the body: ``graphs.eager`` (the eager first run), ``graphs.capture``,
``graphs.upload`` (host inputs into the static inputs; a copy from pageable
memory waits for the stream first) and ``graphs.replay`` (the replay and
the clones of its outputs).  ``eager_runs``, ``captures`` and
``invalidations`` count the rebuilds, beside each program's ``replays``:
after the first two calls of each key they stay put, unless a key changes
from call to call.

On an NCCL rank of a data-parallel world (``parallel/mesh.py``) a program
holds the update's collectives, the gradient all-reduce of each optimizer
step and the metric reduce, as the JAX package's programs over a mesh
hold theirs:

- ProcessGroupNCCL makes its communicator at the first collective: the
  program's eager first run does, before any capture.  The default
  ("global") capture mode holds: ProcessGroupNCCL's watchdog thread does
  not break it, on one rank or on four.
- NCCL frees a communicator only once no graph holds its collectives: a
  rank drops its programs (``SAC.drop_programs``) before its process group
  is destroyed, or the destroy hangs.
- Every rank takes the same programs in the same order, so each replayed
  all-reduce pairs with its peers': the keys (kind, n, gate phase, input
  signature, train mode) and the storage version change alike on every
  rank, whose replicas get the same pushes; where a host lead runs an
  ``act`` program of a chunk, the other ranks run a ``storage`` program of
  the same chunk, whose collectives are the same, in the same order (the
  act has none).
- A replay is not covered by the process group's collective timeout: a
  rank whose peers never replay waits inside its replay, and only the
  stall watchdog (``utils/watchdog.py``, ``train_cfg.stall_timeout``) ends
  it.
- ``TORCH_NCCL_BLOCKING_WAIT`` must be off: a blocking wait would sync the
  host inside the capture.
- The host group's broadcasts (``parallel.distributed.host_broadcast``)
  and the replays go through the current stream, one after another, in the
  same order on every rank of a host.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import pointnet_fused
from ..utils.trace import GRAPHS_CAPTURE, GRAPHS_EAGER, GRAPHS_REPLAY, GRAPHS_UPLOAD, span
from ..utils.tree_ops import tree_map


def input_signature(tree) -> Tuple:
    """The (path, shape, dtype) of every leaf of a host or device tree."""
    if tree is None:
        return ()
    if isinstance(tree, dict):
        return tuple((k, input_signature(v)) for k, v in sorted(tree.items()))
    return (tuple(tree.shape), str(tree.dtype))


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


class _Program:
    def __init__(self, graph, inputs, outputs, launches: Dict[str, int], capture_ms: float, pool_bytes: int):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.launches, self.capture_ms, self.pool_bytes = launches, capture_ms, pool_bytes
        self.replays = 0


class UpdatePrograms:
    """The captured programs of one agent on one card, in one memory pool.

    ``run(key, n, body, inputs, generators, memory)``: ``body(inputs)``
    takes ``n`` updates of the agent (and may act) and returns a tuple of
    output tensors; ``inputs`` is a host or device tree (or None) that is
    copied into the program's static inputs; ``memory`` is the
    ``DeviceReplayMemory`` the body samples, if any."""

    def __init__(self, agent, device: torch.device):
        self.agent = agent
        self.device = device
        self.programs: Dict[Tuple, _Program] = {}
        self.seen = set()  # keys whose body has run eagerly once
        self.stream: Optional[torch.cuda.Stream] = None
        self.pool = None
        self.memory = None  # the replay the storage programs read, and its storage version
        self.version = None
        # rebuilds: eager first runs and captures, and the invalidations that made them run again
        self.eager_runs = self.captures = self.invalidations = 0

    def invalidate(self) -> None:
        """Drop every program (their graphs and memory)."""
        if self.seen:
            self.invalidations += 1
        self.programs.clear()
        self.seen.clear()
        self.pool = None
        self.memory = self.version = None

    def stats(self) -> Dict[str, Any]:
        """The eager first runs, captures and invalidations so far, and per
        program: capture ms, replays, kernels it adds to the launch counts,
        bytes its capture added to the pool."""
        return {"eager_runs": self.eager_runs, "captures": self.captures, "invalidations": self.invalidations,
                "programs": {repr(k): {"capture_ms": p.capture_ms, "replays": p.replays, "launches": p.launches,
                                       "pool_bytes": p.pool_bytes} for k, p in self.programs.items()}}

    def _to_device(self, tree):
        return None if tree is None else tree_map(lambda x: _as_tensor(x).to(self.device), tree)

    def run(self, key: Tuple, n: int, body: Callable, inputs=None, generators: Sequence = (),
            memory=None) -> Tuple[torch.Tensor, ...]:
        if memory is not None and (memory is not self.memory or memory.storage_version != self.version):
            if self.memory is not None:
                self.invalidate()
            self.memory, self.version = memory, memory.storage_version
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        if key not in self.seen:  # the eager first run, on the capture stream
            with span(GRAPHS_EAGER):
                self.stream.wait_stream(current)
                with torch.cuda.stream(self.stream):
                    out = body(self._to_device(inputs))
                current.wait_stream(self.stream)
            self.seen.add(key)
            self.eager_runs += 1
            return out
        prog = self.programs.get(key)
        if prog is None:
            with span(GRAPHS_CAPTURE):
                prog = self.programs[key] = self._capture(key, body, inputs, generators)
            self.captures += 1
        if inputs is not None:
            with span(GRAPHS_UPLOAD):
                tree_map(lambda dst, src: dst.copy_(_as_tensor(src)), prog.inputs, inputs)
        with span(GRAPHS_REPLAY):
            prog.graph.replay()
            prog.replays += 1
            self.agent.updates += n
            for name, count in prog.launches.items():
                pointnet_fused.launch_counts[name] += count
            return tuple(o.clone() for o in prog.outputs)

    def _capture(self, key: Tuple, body: Callable, inputs, generators: Sequence) -> _Program:
        agent = self.agent
        if agent.data_parallel.distributed and os.environ.get("TORCH_NCCL_BLOCKING_WAIT", "0") not in ("", "0"):
            raise RuntimeError("TORCH_NCCL_BLOCKING_WAIT is set: its blocking wait would sync the host inside the "
                               f"capture of the update program {key}; unset it")
        statics = None if inputs is None else tree_map(
            lambda x: torch.empty(tuple(x.shape), dtype=_as_tensor(x).dtype, device=self.device), inputs)
        graph = torch.cuda.CUDAGraph()
        registered = set()
        for gen in generators:
            if gen is not None and gen.device.type == "cuda" and id(gen) not in registered:
                graph.register_generator_state(gen)
                registered.add(id(gen))
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        updates, metric_keys = agent.updates, agent._metric_keys
        counts = dict(pointnet_fused.launch_counts)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()  # as the capture does first: the pool's growth is what it reserves anew
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                outputs = body(statics)
        except Exception as err:
            raise RuntimeError(f"capturing the update program {key} as a CUDA graph failed: {err}") from err
        finally:
            captured = {k: v - counts[k] for k, v in pointnet_fused.launch_counts.items()}
            pointnet_fused.launch_counts.update(counts)
            agent.updates, agent._metric_keys = updates, metric_keys
        torch.cuda.synchronize(self.device)
        capture_ms = 1e3 * (time.perf_counter() - t0)
        pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        return _Program(graph, statics, outputs, {k: v for k, v in captured.items() if v},
                        capture_ms, pool_bytes)
