"""The traffic drivers: set-up, the measured window, and the check.

Two kinds of traffic, each a file of parameters under ``traffic/``:

- ``updates``: the configuration's update program, ``update_parameters_scan``
  of ``n_updates`` (a round), back to back against its replay filled to
  capacity at set-up with seeded transitions (``fill_rows``).  A round's end
  is a CUDA event recorded after it and read after the window; the host
  keeps at most ``in_flight`` rounds queued past the one the card runs (it
  polls the events, it never synchronizes inside the window).  On several
  ranks (a cell of several cards, ``ranks.py``) each rank fills a replica of
  the replay alike and runs the same rounds as a data-parallel rank of the
  port (``parallel.setup_data_parallel``: every rank samples the global
  batch, keeps its rows and all-reduces its gradients); rank 0's events
  time the rounds.
- ``loop``: the configuration's ``train_rl`` loop as ``run_rl`` builds it
  (rollout, agent, replay), after its warm-up: collection by the stand-in
  envs, the act, the replay push and the updates.  A cycle is one turn of
  the loop (``n_steps`` env steps, ``n_updates`` updates); its end is a CUDA
  event recorded where the next collection starts.

Both take the configuration's first rounds at set-up through the window's
own call (``update_parameters_scan`` of the window's ``n`` updates; at
least two rounds, since the update programs run a program's first round
eagerly and capture and replay it from the second, and at least three
updates) on the replay the window samples, and hand the same agent to the
window.  After the window the reference follows those rounds step by step
(``reference.py``, ``checks.py``); a loop cell also holds the fusion and the
replay push of its observations to a plain reference (``fusion.py``).
"""

from __future__ import annotations

import math
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from . import checks, flops, fusion, ranks, reference, standins, tracing, weights

CHECK_UPDATES = 3  # the check's rounds take at least this many updates
CAPTURE_FROM = 4  # a loop cell keeps the fusion calls of window cycle 0 and of one drawn from 1..CAPTURE_FROM-1
FILL_CHUNK = 4096  # rows per fill push; each chunk's draws come from a generator of its own


class WindowClosed(Exception):
    """Raised at the start of the first cycle after the window, to leave ``train_rl``."""


def sub_seed(seed: int, k: int) -> int:
    """The k-th seed of the run (below 2**31 - 2**16, so env seeds plus
    worker indices stay in numpy's range)."""
    return (int(seed) * 2654435761 + 1000003 * k) % (2**31 - 2**16)


def decode(x):
    """A configuration section as the port's builders take it."""
    if isinstance(x, dict):
        if set(x) == {"__slice__"}:
            return slice(*x["__slice__"])
        return {k: decode(v) for k, v in x.items()}
    if isinstance(x, list):
        return [decode(v) for v in x]
    return x


def merge(base: dict, patch: dict) -> dict:
    out = dict(base)
    for k, v in patch.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def env_info(config: dict) -> dict:
    from pointcloud_rl_torch.env.spaces import Box

    ones = np.ones(config["action_dim"], np.float32)
    return dict(obs_shape={k: tuple(v) for k, v in config["obs_shape"].items()}, action_shape=config["action_dim"],
                action_space=Box(-ones, ones), is_discrete=False)


def sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


class Span:
    """Host-clock spans of the benchmark's own, around calls into the program,
    marked in the traced sub-window by ``record_function``."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.active = False  # inside the traced sub-window

    def __call__(self, name: str, fn: Callable, *a, **kw):
        import torch

        t0 = time.perf_counter()
        if self.active:
            with torch.profiler.record_function(name):
                out = fn(*a, **kw)
        else:
            out = fn(*a, **kw)
        self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0
        return out


# ------------------------------------------------------------------ set-up
def build_agent(config: dict, device, seeds: dict):
    from pointcloud_rl_torch.algorithms import build_agent as port_build_agent

    agent = port_build_agent(dict(decode(config["agent_cfg"]), env_params=env_info(config), seed=seeds["agent"],
                                  device=str(device)))
    shapes = weights.shapes_of(agent.model.named_parameters())
    weights.load_into(agent, weights.make(shapes, seeds["weights"], device, config["reference"]["encoder"]))
    return agent, shapes


def fill_rows(config: dict, seed: int, chunk: int, rows: int, device) -> dict:
    """``rows`` seeded transitions, chunk ``chunk`` of the fill, shaped and
    ranged like the stand-in's observations: for the walker, frames of
    body points (the stand-in's sphere colours, above the ground) then
    ground points (z = 0, its checker colours) and the frame one-hot; for
    ManiSkill, each segment's budget of points in its colour and the
    background, off the ground, with a robot state."""
    import torch

    g = torch.Generator(device=device).manual_seed(int(seed) * 1009 + chunk)
    env = config["env"]
    A = int(config["action_dim"])

    def u(*shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo

    def obs():
        if env["kind"] == "walker":
            F, P, NG = int(env["frames"]), int(env["n_points"]), int(env["num_ground"])
            NB = P - NG
            x0 = u(rows, 1, 1, lo=0.0, hi=20.0)
            body = torch.stack([x0 + u(rows, F, NB, lo=-0.35, hi=0.35), u(rows, F, NB, lo=-0.2, hi=0.2),
                                u(rows, F, NB, lo=0.01, hi=1.4)], 1)
            ground = torch.stack([x0 + u(rows, F, NG, lo=-1.5, hi=2.5), u(rows, F, NG, lo=-0.5, hi=3.5),
                                  torch.zeros(rows, F, NG, device=device)], 1)
            xyz = torch.cat([body, ground], -1).reshape(rows, 3, F * P)
            pal_b = torch.as_tensor(standins.WalkerRawStandIn.body_colors(), device=device)
            pal_g = torch.as_tensor(np.asarray(standins.WalkerRawStandIn.GROUND, np.uint8), device=device)
            cb = pal_b[(u(rows, F, NB) * len(pal_b)).long().clamp_max(len(pal_b) - 1)]
            cg = pal_g[(u(rows, F, NG) * len(pal_g)).long().clamp_max(len(pal_g) - 1)]
            rgb = torch.cat([cb, cg], 2).reshape(rows, F * P, 3).transpose(1, 2).contiguous()
            pos = torch.eye(F, dtype=torch.uint8, device=device).repeat_interleave(P, -1).expand(rows, F, F * P)
            return {"xyz": xyz, "rgb": rgb, "pos_encoding": pos.contiguous()}
        P = int(env["n_points"])
        budget = checks.seg_budget(standins.MANISKILL_SEGMENTS, P, int(env["min_pts"]), int(env["fg_pts"]))
        which = torch.cat([torch.full((n,), i, device=device) for i, n in enumerate(budget)])  # 0..2 segments, 3 bg
        seg = torch.stack([which == i for i in range(3)], 0).expand(rows, 3, P)
        pal = torch.as_tensor(standins.MANISKILL_COLORS[1:], dtype=torch.float32, device=device)
        col = (pal[which].T[None] + u(rows, 3, P, lo=-0.05, hi=0.05)).clamp(0, 1)
        xyz = torch.stack([u(rows, P, lo=-1.5, hi=1.5), u(rows, P, lo=-1.5, hi=1.5), u(rows, P, lo=0.01, hi=1.5)], 1)
        state = (u(rows, int(config["obs_shape"]["state"][0])) - 0.5)
        return {"xyz": xyz, "rgb": (col * 255).to(torch.uint8), "seg": seg.contiguous(), "state": state}

    return {"obs": obs(), "next_obs": obs(), "actions": u(rows, A, lo=-1.0, hi=1.0),
            "rewards": u(rows, lo=0.0, hi=0.5), "dones": torch.zeros(rows, dtype=torch.bool, device=device),
            "episode_dones": torch.zeros(rows, dtype=torch.bool, device=device)}


def to_host(tree):
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree.cpu().numpy()


def reference_obs(obs: dict, config: dict, stored: bool = True) -> dict:
    """An observation as the reference's nets take it: ``{"pcd": [B, N, C]
    f32 (xyz, rgb/255, the frame one-hot or seg), "state"?}``.  A replay
    row (``stored``) of a configuration that packs its replay is rounded to
    bf16, as the configuration stores it."""
    import torch

    if "pcd" in obs:  # a packed replay's rows as they are stored
        return {"pcd": obs["pcd"].float()}
    feats = [obs["xyz"].float(), obs["rgb"].float() / 255.0]
    for key in ("pos_encoding", "seg"):
        if key in obs:
            feats.append(obs[key].float())
    pcd = torch.cat(feats, dim=1).transpose(1, 2)
    if stored and config["reference"].get("packed"):
        pcd = pcd.to(torch.bfloat16).float()
    out = {"pcd": pcd.contiguous()}
    if "state" in obs:
        out["state"] = obs["state"].float()
    return out


def reference_batch(rows: dict, config: dict) -> dict:
    r, d = rows["rewards"].float(), rows["dones"].float()
    return {"obs": reference_obs(rows["obs"], config), "next_obs": reference_obs(rows["next_obs"], config),
            "actions": rows["actions"].float(), "rewards": r.reshape(-1, 1), "dones": d.reshape(-1, 1)}


def take(tree, idx):
    if isinstance(tree, dict):
        return {k: take(v, idx) for k, v in tree.items()}
    return tree[idx]


def check_rounds(n: int) -> int:
    """Rounds of ``n`` updates the check takes: two or more (the first runs
    eagerly, the second is the captured program), three updates or more."""
    return max(2, -(-CHECK_UPDATES // n))


def observed_steps(n: int) -> int:
    """The first steps the check reads one by one: three, inside the first
    round where a round is several updates."""
    return CHECK_UPDATES if n == 1 else min(CHECK_UPDATES, n)


def program_check(agent, call: Callable[[], Any], rounds: int, n: int) -> dict:
    """The program's readings over its first ``rounds`` rounds of the
    window's call (``call()`` runs one round of ``n`` updates and returns its
    summed metric vector): each of the first three steps' losses, the first
    moments after the first step and after the last, the change over the
    first three steps and over all of them, each round's losses.  Where a
    round is several updates, the first three steps are read inside the
    first round, which the update programs run eagerly, one step after
    another (``_update_vec``)."""
    before = checks.program_params(agent)
    st: Dict[str, Any] = {"steps": [], "grad1": {}, "after3": None}
    observed = observed_steps(n)

    def observe(vec):
        st["steps"].append(checks.program_losses(agent, vec))
        if len(st["steps"]) == 1:
            st["grad1"] = checks.program_grad1(agent)
        if len(st["steps"]) == observed:
            st["after3"] = checks.program_params(agent)

    if n > 1:
        one_step = agent._update_vec

        def stepped(memory):
            vec = one_step(memory)
            if len(st["steps"]) < observed:
                observe(vec)
            return vec

        agent._update_vec = stepped
    round_losses = []
    agent.train()
    try:
        for _ in range(rounds):
            vec = call()
            if n > 1:
                agent.__dict__.pop("_update_vec", None)  # the captured program takes the method itself
            else:
                observe(vec)
            round_losses.append(checks.program_losses(agent, vec))
    finally:
        agent.__dict__.pop("_update_vec", None)
    return {"losses": st["steps"], "grad1": st["grad1"],
            "change": checks.param_change(st["after3"], before), "round_losses": round_losses,
            "round_change": checks.program_change(agent, before), "moments": checks.program_grad1(agent)}


def plant_fault(agent, fault: Optional[str], device) -> None:
    """Break the timed path underneath (the benchmark's own tests only):
    ``unchanged`` makes every step leave the train state as it was;
    ``half_batch`` takes every update over the first half of its rows (on
    several ranks, the first half of the global batch split over them);
    ``exchange_left_out`` steps each rank on its own rows' gradient, with
    no all-reduce (``fuse_altered``, a loop cell's, moves a fused point;
    ``action_altered`` alters a pushed action)."""
    if fault == "unchanged":  # no optimizer step, and a target rate of 0 (this agent's alone)
        for tx in (agent.critic_tx, agent.actor_tx, agent.alpha_tx):
            if tx.opt is not None:
                tx.opt.step = lambda *a, **k: None
        agent.taus = {k: 0.0 for k in agent.taus}
    elif fault == "half_batch":
        from pointcloud_rl_torch.utils.tree_ops import tree_map

        dp = agent.data_parallel

        class Half(type(dp)):
            def shard(self, batch):
                return super().shard(tree_map(lambda x: x[: x.shape[0] // 2], batch))

        dp.__class__ = Half
    elif fault == "exchange_left_out":
        dp = agent.data_parallel

        class Alone(type(dp)):
            def allreduce_grads(self, grads):
                return grads

        dp.__class__ = Alone


def free(device) -> None:
    """Free what the program held (its graphs and the agent refer to each other)."""
    import gc

    gc.collect()
    if device.type == "cuda":
        import torch

        torch.cuda.empty_cache()


def memory_peak(device) -> int:
    if device.type != "cuda":
        return 0
    import torch

    return int(torch.cuda.max_memory_allocated(device))


def world_size() -> int:
    """The ranks of this run: those of its process group, else one."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def device_record(device) -> dict:
    """This rank's card (the harness puts the ranks' records together)."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": world_size(), "memory_peak_bytes": 0}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": world_size(),
            "memory_peak_bytes": memory_peak(device)}


def p95(values: List[float]) -> float:
    return float(np.percentile(np.asarray(values, np.float64), 95)) if values else math.nan


def event_ms(events) -> List[float]:
    """Times between consecutive CUDA events (ms), read after the window."""
    return [float(a.elapsed_time(b)) for a, b in zip(events[:-1], events[1:])]


class Clock:
    """Cycle ends: CUDA events on a card, the host clock elsewhere."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self):
        if self.cuda:
            import torch

            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())
        return self.marks[-1]

    def cycle_ms(self) -> List[float]:
        if self.cuda:
            return event_ms(self.marks)
        return [1e3 * (b - a) for a, b in zip(self.marks[:-1], self.marks[1:])]


def nonfinite_count(vecs) -> int:
    import torch

    return sum(int(not bool(torch.isfinite(v).all())) for v in vecs)


# ------------------------------------------------------------------ the drivers
def run(cell, args, device: str, t_proc: float, tweak: dict) -> dict:
    import torch

    config = merge(cell.config, tweak.get("config", {}))
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    seeds = {k: sub_seed(args.seed, i) for i, k in enumerate(("agent", "replay", "env", "weights", "fill"), 1)}
    kind = cell.traffic["kind"]
    driver = {"updates": UpdatesDriver, "loop": LoopDriver}[kind]
    return driver(cell, config, args, dev, t_proc, seeds, tweak).run()


class _Driver:
    def __init__(self, cell, config, args, device, t_proc, seeds, tweak):
        self.cell, self.config, self.args, self.device = cell, config, args, device
        self.t_proc, self.seeds, self.tweak = t_proc, seeds, tweak
        self.traffic = merge(cell.traffic, tweak.get("traffic", {}))
        self.spans = Span()
        self.trace: Optional[tracing.Trace] = None
        self.prof = None
        self.traced = False
        self.notes: List[str] = []
        self.launches0: Dict[str, int] = {}

    # the traced sub-window
    def trace_start(self):
        from pointcloud_rl_torch.ops import pointnet_fused
        import torch

        sync(self.device)
        self.launches0 = dict(pointnet_fused.launch_counts)
        self.prof = tracing.start(self.device.type)
        self._window_span = torch.profiler.record_function(tracing.WINDOW_SPAN)
        self._window_span.__enter__()
        self.spans.active = True

    def trace_stop(self):
        from pointcloud_rl_torch.ops import pointnet_fused

        sync(self.device)
        self._window_span.__exit__(None, None, None)
        self.spans.active = False
        self.prof.stop()  # its trace is read once the window has closed
        self.traced = True
        self.launches = {k: v - self.launches0.get(k, 0) for k, v in pointnet_fused.launch_counts.items()}

    def read_trace(self) -> None:
        if self.prof is not None:
            self.trace = tracing.read(self.prof)
            self.prof = None

    def read_context(self, window: dict) -> dict:
        """What the per-layer readers read, on this rank.  ``kernel_rows``:
        the rows a kernel of the update runs at on this rank (its share of
        the global batch); ``flops``: one global update's; ``chips``: the
        ranks over which the window's updates ran; ``traced_updates``: the
        updates of the traced sub-window."""
        self.read_trace()
        shapes = self.config["shapes"]
        world = world_size()
        batch = int(shapes["batch_size"]) // world
        rows = {batch * int(shapes.get("num_aug", 1)), batch}
        rows |= set(self.act_rows())
        return {"trace": self.trace, "config": self.config, "cell": self.cell.name, "window": window,
                "spans": self.window_spans, "launches": getattr(self, "launches", {}),
                "kernel_rows": sorted(rows), "chips": world, "traced_updates": getattr(self, "traced_updates", 0),
                "flops": flops.update_flops(shapes, self.config["reference"]["encoder"])}

    def act_rows(self) -> List[int]:
        return []

    def result(self, window: dict, compared: dict, attempted: int, failed: int, dev_rec: dict) -> dict:
        out = {"end_to_end": {"updates_per_s": window["updates"] / window["seconds"],
                              "cycle_ms_p95": p95(window["cycle_ms"]), "setup_s": window["setup_s"]},
               "compared": compared, "attempted": attempted, "failed": failed, "device": dev_rec,
               "read": self.read_context(window), "notes": self.notes,
               "readings": getattr(self, "readings", None)}
        if self.trace is not None and self.device.type == "cuda":
            busy = self.trace.busy_us(clip=(self.trace.t0, self.trace.t1))
            dev_rec["busy_s"] = busy / 1e6
            dev_rec["window_s"] = self.trace.window_us / 1e6
            out["breakdown"] = {"device_ops": self.trace.device_ops(), "idle_gaps": self.trace.idle_gaps()}
        self.notes.append(f"window: {window['updates']} updates in {window['seconds']:.3f} s over "
                          f"{len(window['cycle_ms'])} cycles; set-up {window['setup_s']:.2f} s")
        return out

    def check_reference(self, got: dict, batches: List[dict], shapes, per_round: int, act=None) -> dict:
        """Run the reference over the check's steps (on ``batches``, rounds of
        ``per_round``) and compare.  ``act(state, gen, spec, precision)`` gives the reference's
        first act after the steps, beside the program's (``act_gap``).  With
        ``tweak["readings"]`` the control (the reference in the precision
        below the configuration's) and the planted faults are read too, on
        the same batches (``self.readings``)."""
        import torch

        spec = reference.Spec(self.config["reference"])
        w = weights.make(shapes, self.seeds["weights"], self.device, self.config["reference"]["encoder"])

        observed = observed_steps(per_round)

        def steps(precision="float32", fault=None, some=None):
            gen = torch.Generator(device=self.device).manual_seed(self.seeds["agent"])
            some = batches if some is None else some
            out = reference.run_steps(w, [lambda b=b: b for b in some], gen, spec, precision, fault,
                                      per_round if some is batches else 1, observed)
            out["gen"] = gen
            return out

        want = steps()
        own = self.config["precision"]
        yard = steps(own, some=batches[:observed]) if own != "float32" else None
        compared = checks.compare(got, want, yard)
        ref_act = None
        if act is not None:
            ref_act = act(want["state"], want["gen"], spec, "float32")
            compared["act_gap"] = {"value": float(np.abs(self.first_actions - ref_act).max()),
                                   "at": "the first act after the check"}
        if self.tweak.get("readings"):
            self.readings = {"program": {k: v["value"] for k, v in compared.items()}}
            for name, precision, fault in (("control", self.config["control"], None),
                                           ("half_batch", "float32", "half_batch"),
                                           ("unchanged", "float32", "unchanged"),
                                           ("one_draw", "float32", "one_draw")):
                other = steps(precision, fault)
                rec = {k: v["value"] for k, v in checks.compare(other, want, yard).items()}
                if act is not None and fault is None:
                    rec["act_gap"] = float(np.abs(act(other["state"], other["gen"], spec, precision) - ref_act).max())
                self.readings[name] = rec
        return compared


class UpdatesDriver(_Driver):
    def run(self) -> dict:
        import torch

        from pointcloud_rl_torch.env import build_replay

        cfg, dev = self.config, self.device
        agent, shapes = build_agent(cfg, dev, self.seeds)
        replay = build_replay(decode(cfg["replay_cfg"]), dict(seed=self.seeds["replay"]), device=dev)
        on_device = type(replay).__name__ == "DeviceReplayMemory"
        capacity = int(self.traffic.get("fill_rows") or replay.capacity)
        for c in range(-(-capacity // FILL_CHUNK)):
            rows = fill_rows(cfg, self.seeds["fill"], c, min(FILL_CHUNK, capacity - c * FILL_CHUNK), dev)
            replay.push_batch(rows if on_device else to_host(rows))
        sync(dev)
        if world_size() > 1:
            from pointcloud_rl_torch.parallel import setup_data_parallel

            setup_data_parallel(agent, world_size(), replay=replay)
        plant_fault(agent, self.tweak.get("fault"), dev)

        # the first rounds, through the window's call on the window's replay
        n = int(cfg["train_cfg"]["n_updates"])
        checked = check_rounds(n)
        drawn: List[np.ndarray] = []
        if not on_device:  # a host replay draws its rows on the host: the reference takes its indices
            sampler = replay.sampling.sample

            def recorded(batch_size, size, capacity):
                idx = sampler(batch_size, size, capacity)
                drawn.append(np.asarray(idx).copy())
                return idx

            replay.sampling.sample = recorded
        size_at_check = len(replay)
        got = program_check(agent, lambda: agent.update_parameters_scan(replay, n), checked, n)
        if not on_device:
            replay.sampling.sample = sampler

        for _ in range(int(self.traffic["warm_rounds"])):  # replays of the captured program
            agent.update_parameters_scan(replay, n)
        sync(dev)

        # the window
        in_flight = int(self.traffic["in_flight"])
        trace_from = int(self.traffic["trace_from"])
        trace_rounds = int(self.traffic["trace_rounds"]) if self.args.trace else 0
        clock = Clock(dev)
        vecs: List = []
        end = ranks.WindowEnd(in_flight)
        setup_s = time.time() - self.t_proc
        t0 = time.perf_counter()
        clock.mark()
        rounds = 0
        while True:
            if rounds == trace_from and trace_rounds:
                self.trace_start()
            vecs.append(self.spans("updates.scan", agent.update_parameters_scan, replay, n))
            clock.mark()
            rounds += 1
            if rounds == trace_from + trace_rounds and trace_rounds:
                self.trace_stop()
            if clock.cuda and len(clock.marks) > in_flight + 1:
                mark = clock.marks[-1 - in_flight]
                while not mark.query():
                    time.sleep(2e-4)
            time_up = time.perf_counter() - t0 >= self.args.seconds and (not trace_rounds or self.traced)
            if end.reached(rounds, time_up):
                break
        sync(dev)
        seconds = time.perf_counter() - t0
        self.traced_updates = trace_rounds * n
        window = {"updates": rounds * n, "seconds": seconds, "cycle_ms": clock.cycle_ms(), "setup_s": setup_s,
                  "cycles": rounds}
        self.window_spans = {k: v / rounds for k, v in self.spans.totals.items()}
        failed = nonfinite_count(vecs)
        dev_rec = device_record(dev)

        # the reference, once the program's state is freed (an NCCL rank's
        # graphs first: they hold its communicator)
        agent.drop_programs()
        del agent, vecs, clock
        if on_device:
            del replay
        else:
            replay = None
        free(dev)

        def fill_take(idx: np.ndarray) -> dict:
            """The fill's rows ``idx`` (a step's), made again from the seed, chunk by chunk."""
            out = None
            for c in np.unique(idx // FILL_CHUNK):
                pos = np.nonzero(idx // FILL_CHUNK == c)[0]
                rows = fill_rows(cfg, self.seeds["fill"], int(c), min(FILL_CHUNK, capacity - int(c) * FILL_CHUNK), dev)
                part = take(rows, torch.as_tensor(idx[pos] % FILL_CHUNK, device=dev))
                if out is None:
                    out = _zeros(part, len(idx))
                _assign(out, torch.as_tensor(pos, device=dev), part)
            return reference_batch(out, cfg)

        B = int(cfg["reference"]["batch_size"])
        if on_device:  # the replay's index draws, from its seed
            drawn = list(replay_draws(self.seeds["replay"], B, size_at_check, checked * n, dev).cpu().numpy())
        every = fill_take(np.concatenate(drawn))  # all the steps' rows at once, then one batch per step
        batches = [take(every, slice(i * B, (i + 1) * B)) for i in range(len(drawn))]
        compared = self.check_reference(got, batches, shapes, per_round=n)
        return self.result(window, compared, attempted=rounds, failed=failed, dev_rec=dev_rec)


def replay_draws(seed: int, batch: int, size: int, steps: int, device):
    """``[steps, batch]``: a device replay's index draws (64 random bits
    modulo its size), from its seed, one step after another."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.stack([torch.randint(0, 2**62, (batch,), generator=gen, device=device).remainder(size)
                        for _ in range(steps)])


def _zeros(tree, n: int):
    import torch

    if isinstance(tree, dict):
        return {k: _zeros(v, n) for k, v in tree.items()}
    return torch.zeros((n,) + tuple(tree.shape[1:]), dtype=tree.dtype, device=tree.device)


def _assign(out, pos, part) -> None:
    if isinstance(out, dict):
        for k in out:
            _assign(out[k], pos, part[k])
    else:
        out[pos] = part


class LoopDriver(_Driver):
    def act_rows(self) -> List[int]:
        r = self.config["rollout_cfg"]
        envs = int(r.get("num_procs", 1))
        groups = r.get("pipeline_groups")
        groups = (2 if envs >= 2 else 1) if groups is None else int(groups)
        return [envs // max(groups, 1)]

    def run(self) -> dict:
        import torch

        from pointcloud_rl_torch.apis.train_rl import train_rl
        from pointcloud_rl_torch.env import build_replay, build_rollout

        cfg, dev = self.config, self.device
        env_cfg = dict(decode(cfg["env_cfg"]), type=standins.register_walker())
        rollout_cfg = dict(decode(cfg["rollout_cfg"]), env_cfg=env_cfg, base_seed=self.seeds["env"], device=str(dev))
        rollout = build_rollout(rollout_cfg)
        try:
            return self._run(rollout, train_rl, build_replay, torch)
        finally:
            rollout.close()

    def _run(self, rollout, train_rl, build_replay, torch) -> dict:
        cfg, dev = self.config, self.device
        train_cfg = cfg["train_cfg"]
        agent, shapes = build_agent(cfg, dev, self.seeds)
        replay = build_replay(decode(cfg["replay_cfg"]), dict(seed=self.seeds["replay"]), device=dev)
        warm = int(self.traffic.get("warm_steps") or train_cfg["warm_steps"])
        rollout.forward_with_policy(None, warm, replay)  # the config's warm-up, random actions
        sync(dev)
        plant_fault(agent, self.tweak.get("fault"), dev)

        # the first rounds, through the window's call (train_rl's update chunk) on the window's replay
        n_steps, n_updates = int(train_cfg["n_steps"]), int(train_cfg["n_updates"])
        events = max((n_steps // rollout.num_envs) * rollout.pipeline_groups, 1)
        chunk = max(1, n_updates // events)
        checked = check_rounds(chunk)
        size_at_check = len(replay)
        got = program_check(agent, lambda: agent.update_parameters_scan(replay, chunk), checked, chunk)

        # the loop, with the benchmark's spans around the calls into it
        collect, forward_async, push = rollout.forward_with_policy, agent.forward_async, replay.push_batch
        server = rollout.vec_env.vec_env  # the ServerObsVectorEnv under the unified API
        fuse = server._fuse
        scan = agent.update_parameters_scan
        st: Dict[str, Any] = {"phase": "warm", "cycle": 0, "window_cycles": 0, "updates": 0, "in_collect": False,
                              "hook_s": 0.0, "collect_ms": [], "dispatches": [], "pushes": [], "vecs": [],
                              "first_obs": None, "captures": []}
        clock = Clock(dev)
        warm_cycles = int(self.traffic["warm_cycles"])
        trace_from = int(self.traffic["trace_from"])
        trace_cycles = int(self.traffic["trace_cycles"]) if self.args.trace else 0
        seconds = float(self.args.seconds)
        fault = self.tweak.get("fault")
        capture_at = {0, int(np.random.default_rng(self.seeds["env"]).integers(1, CAPTURE_FROM))}

        def counted(fn, name):
            def call(memory, n):
                t0 = time.perf_counter()
                vec = self.spans(name, fn, memory, n)
                if st["in_collect"]:
                    st["hook_s"] += time.perf_counter() - t0
                if st["phase"] == "window":
                    st["updates"] += n
                    st["vecs"].append(vec)
                return vec
            return call

        def recorded_act(obs, mode="explore", **kw):
            handle = self.spans("agent.forward_async", forward_async, obs, mode=mode, **kw)
            if st["first_obs"] is None:
                st["first_obs"] = to_host_tree(obs)
                st["first_handle"] = handle
            st["dispatches"].append((st["cycle"], handle))
            return handle

        def recorded_push(items):
            if fault == "action_altered" and st["phase"] == "window":
                items = dict(items)
                items["actions"] = np.array(items["actions"], copy=True)
                items["actions"][0] += 0.25
            st["pushes"].append((st["cycle"], np.array(items["actions"], copy=True)))
            return self.spans("replay.push_batch", push, items)

        def captured_fuse(raw):
            out = fuse(raw)
            if st["phase"] == "window" and st["in_collect"]:
                if fault == "fuse_altered":
                    out["xyz"][0, 0, 0] += 0.05
                if st["window_cycles"] - 1 in capture_at:  # the raw renders as the program got them
                    st["captures"].append(({k: np.array(raw[k], copy=True) for k in ("depth", "rgb", "cam")}, out))
            return out

        def timed_collect(pi, num, replay_=None, **kw):
            if pi is None:
                return collect(pi, num, replay_, **kw)
            now = time.perf_counter()
            if st["phase"] == "warm" and st["cycle"] >= warm_cycles:
                sync(dev)
                st["phase"], st["t0"] = "window", time.perf_counter()
                st["setup_s"] = time.time() - self.t_proc
                clock.mark()
                self.spans.totals.clear()
                st["window_cycles"] += 1
            elif st["phase"] == "window":
                clock.mark()
                if trace_cycles and st["window_cycles"] == trace_from + trace_cycles:
                    self.trace_stop()
                if now - st["t0"] >= seconds and (not trace_cycles or self.traced):
                    sync(dev)
                    st["t1"] = time.perf_counter()
                    raise WindowClosed()
                if trace_cycles and st["window_cycles"] == trace_from:
                    self.trace_start()
                st["window_cycles"] += 1
            st["cycle"] += 1
            st["in_collect"], st["hook_s"] = True, 0.0
            t0 = time.perf_counter()
            try:
                out = self.spans("rollout.forward_with_policy", collect, pi, num, replay_, **kw)
            finally:
                st["in_collect"] = False
            if st["phase"] == "window":
                st["collect_ms"].append(1e3 * (time.perf_counter() - t0 - st["hook_s"]))
            return out

        rollout.forward_with_policy = timed_collect
        agent.forward_async = recorded_act
        replay.push_batch = recorded_push
        server._fuse = captured_fuse
        agent.update_parameters_scan = counted(scan, "updates.scan")
        work = tempfile.mkdtemp(prefix="pcbench_")  # under TMPDIR; the window ends before any checkpoint
        try:
            train_rl(agent, rollout, None, replay, work_dir=work, total_steps=10**12, warm_steps=warm,
                     n_steps=n_steps, n_updates=n_updates, n_log=int(train_cfg["n_log"]), n_eval=-1,
                     n_checkpoint=int(train_cfg["n_checkpoint"]), stall_timeout=float(train_cfg["stall_timeout"]),
                     save_replay=0)
            raise RuntimeError("train_rl returned before the window closed")
        except WindowClosed:
            pass
        finally:
            shutil.rmtree(work, ignore_errors=True)
        cycles = st["window_cycles"]
        window = {"updates": st["updates"], "seconds": st["t1"] - st["t0"], "cycle_ms": clock.cycle_ms(),
                  "setup_s": st["setup_s"], "cycles": cycles}
        self.window_spans = {k: v / max(cycles, 1) for k, v in self.spans.totals.items()}
        self.window_spans["collect_ms"] = float(np.mean(st["collect_ms"])) if st["collect_ms"] else math.nan
        failed = nonfinite_count(st["vecs"])
        dev_rec = device_record(dev)

        # the act and the push: every pushed action row is one the act dispatched
        lag = int(cfg["rollout_cfg"].get("action_lag", 0))
        push_faults = push_mismatches(st["dispatches"], st["pushes"], lag)
        first_actions = np.asarray(st["first_handle"], np.float64)
        first_obs = st["first_obs"]

        # the observation stage: the fusion of the captured cycles, and their clouds in the replay
        captures = st["captures"]
        filled = len(replay)
        store_faults = fusion.store_faults(captures, {k: replay.storage[k]["pcd"][:filled]
                                                      for k in ("obs", "next_obs")})
        # the rows the check's updates sampled
        B = int(cfg["reference"]["batch_size"])
        idxs = replay_draws(self.seeds["replay"], B, size_at_check, checked * chunk, dev)
        rows = [{k: take(replay.storage[k], i) for k in ("obs", "next_obs", "actions", "rewards", "dones")}
                for i in idxs]

        del agent, replay, st["vecs"], st["dispatches"], clock
        free(dev)
        self.first_actions = first_actions
        z_to_world = standins.WalkerRawStandIn.Z_TO_WORLD
        fuse_faults = fusion.fuse_faults(captures, cfg["env"], z_to_world, dev) if captures else 1
        del captures, st["captures"]

        def act(state, gen, spec, precision):
            """The explore act on the first dispatch's observations, from ``state``."""
            obs = reference_obs({k: torch.as_tensor(v).to(dev) for k, v in first_obs.items()}, cfg, stored=False)
            with reference.precise():
                feat = spec.encoder.encode(state["P"], obs["pcd"], precision)
                x = torch.cat([feat, obs["state"]], -1) if "state" in obs else feat
                out = reference.mlp(state["P"], "actor.final_mlp.", x, spec.actor_layers, precision)
                mean, log_std = out.chunk(2, -1)
                std = log_std.clamp(*spec.log_std_bound).exp()
                noise = torch.randn(mean.shape, generator=gen, device=dev, dtype=torch.float32)
                return torch.tanh(mean + std * noise).double().cpu().numpy()

        compared = self.check_reference(got, [reference_batch(r, cfg) for r in rows], shapes, per_round=chunk,
                                        act=act)
        compared["fuse_faults"] = {"value": float(fuse_faults), "at": f"frames of window cycles {sorted(capture_at)}"}
        compared["store_faults"] = {"value": float(store_faults), "at": "fused observations not in the replay"}
        compared["push_faults"] = {"value": float(push_faults), "at": "pushed actions that no act dispatched"}
        return self.result(window, compared, attempted=cycles, failed=failed, dev_rec=dev_rec)


def to_host_tree(tree):
    if isinstance(tree, dict):
        return {k: np.array(v, copy=True) for k, v in tree.items()}
    return np.array(tree, copy=True)


def push_mismatches(dispatches, pushes, lag: int) -> int:
    """Cycles whose pushed action rows are not, as a multiset, the rows the
    act dispatched in that cycle (``lag`` 0) or in the cycle before (``lag``
    1; the first cycle applies its own)."""
    by_cycle: Dict[int, list] = {}
    for c, h in dispatches:
        by_cycle.setdefault(c, []).append(np.asarray(h))
    bad = 0
    for c, applied in pushes:
        src = max(c - lag, min(by_cycle)) if by_cycle else c
        sent = np.concatenate(by_cycle.get(src, [np.zeros((0,) + applied.shape[1:])]))
        a = np.asarray(applied, np.float64).reshape(len(applied), -1)
        s = np.asarray(sent, np.float64).reshape(len(sent), -1)
        if a.shape != s.shape or not np.array_equal(a[np.lexsort(a.T[::-1])], s[np.lexsort(s.T[::-1])]):
            bad += 1
    return bad
