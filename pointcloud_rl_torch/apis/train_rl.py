"""The online off-policy training loop (port of ``pointcloud_rl_tpu/apis/train_rl.py``).

Warm-up random steps, then alternate collect(n_steps) / update(n_updates)
until total_steps, with episode statistics, periodic logging, evaluation,
checkpoints every n_checkpoint steps as ``models/model_<step>`` plus
``model_final``, and a numbered checkpoint on SIGTERM.  ``profile_steps``
traces the first that many env steps of the main loop with
``torch.profiler`` into ``<work_dir>/profile``.

The updates of a cycle take the JAX loop's branches:
- interleaved with collection: with a ``DeviceReplayMemory``,
  ``n_updates > 1`` and an agent with ``update_parameters_scan``, the
  rollout's ``update_hook`` runs a chunk of ``n_updates // (act dispatches
  per collection)`` updates after each act dispatch, or, with
  ``act_fused_updates``, each explore act takes its chunk inside its own
  program (``set_fused_updates``); the remainder runs after the
  collection.  The pipelined rollout pushes once, at the end of a
  collection, so these updates sample the buffer as it stood before the
  cycle's push;
- otherwise one ``update_parameters_scan(replay, n_updates)`` per cycle
  when ``n_updates > 1``, else ``update_parameters_lazy`` per update.
The metric vectors stay on the device, summed, and are fetched and
averaged once per log interval (``reduce_metric_vecs``): no update waits
for the host.  On a card each of these programs replays a captured CUDA
graph (``algorithms/graphs.py``), an NCCL rank's with its gradient
all-reduces inside; a gloo rank runs its updates eagerly (its collectives
run on the host) and says so once.  On a host of several ranks the
interleave runs in lockstep: the host lead announces each chunk it runs
inside its collection (``LeadRollout.announce_updates``), and each other
rank's ``ReplicaRollout`` makes the pushes made so far and runs the same
chunk, so every rank samples the buffer as it stood before the cycle's
push, and every rank counts the updates it ran for the remainder.

``stall_timeout`` arms the stall watchdog (``utils/watchdog.py``): with no
loop progress for that many seconds, the run appends to
``<work_dir>/STALLED`` and exits with the watchdog's code, so a
supervisor can rerun it with ``--auto-resume``.

``save_replay=N`` writes the N newest transitions next to each
checkpoint (``models/replay_latest.h5``), which ``run_rl`` restores on a
resume; ``expert_replay`` becomes ``agent.expert_replay``;
``recent_traj_replay`` receives every transition of a collection and is
emptied at each log boundary.

A data-parallel agent (``parallel.setup_data_parallel``) runs this loop
on every rank: each host lead's rollout collects and its pushes reach
every replay of its host (``parallel.replicate_rollout``), each update is
split over the ranks, one stop flag is agreed per cycle, the episode
statistics logged are the mean over the hosts (``mean_over_hosts``), and
rank 0 alone evaluates, logs and saves checkpoints and replay snapshots,
while the other ranks wait in the next collective.
"""

from __future__ import annotations

import os
import os.path as osp
import signal
import time
from collections import defaultdict
from typing import Any, Dict, Optional

import numpy as np

from ..parallel.distributed import allreduce_stats, is_host_lead, mean_over_hosts
from ..parallel.mesh import ReplicaRollout
from ..utils.checkpoint import save_checkpoint
from ..utils.logger import get_logger
from ..utils.process import get_total_memory_mb
from ..utils.stats import EpisodicStatistics, EveryNSteps
from ..utils.timer import format_eta
from ..utils.tree_ops import dict_to_str


def train_rl(
    agent,
    rollout,
    evaluator,
    replay,
    work_dir: str,
    total_steps: int,
    warm_steps: int = 0,
    n_steps: int = 1,
    n_updates: int = 1,
    n_log: int = 1000,
    n_eval: int = -1,
    n_checkpoint: int = -1,
    on_policy: bool = False,
    resume_steps: int = 0,
    eval_num: Optional[int] = None,
    exp_logger=None,
    ep_stats_cfg: Optional[dict] = None,
    profile_steps: int = 0,
    save_replay: int = 0,
    expert_replay=None,
    recent_traj_replay=None,
    stall_timeout: float = 0.0,
    act_fused_updates: bool = False,
) -> Dict[str, Any]:
    """Train; returns the step counts and the main loop's wall time
    (``main_loop_s``, from the end of the warm-up to the last update).

    ``act_fused_updates``: where updates interleave with collection, run
    each chunk inside the explore act that precedes it, as one program.

    ``save_replay=N`` (N > 0): at each checkpoint, the lead writes the
    ``min(N, len(replay))`` newest transitions in push order to
    ``<work_dir>/models/replay_latest.h5`` (``save_replay_snapshot``), so a
    resume continues from a warm buffer."""
    logger = get_logger("pcrl")
    lead = agent.data_parallel.is_lead
    watchdog = None
    if stall_timeout and stall_timeout > 0:
        from ..utils.watchdog import StallWatchdog

        def mark_stalled():
            with open(osp.join(work_dir, "STALLED"), "a") as f:
                f.write(f"{time.time()}\n")

        watchdog = StallWatchdog(stall_timeout, on_stall=mark_stalled)
    try:
        if expert_replay is not None:
            # agents with demo-augmented objectives read it in their update
            agent.expert_replay = expert_replay
            logger.info(f"Expert replay attached: {len(expert_replay)} transitions"
                        + (" (dynamic)" if getattr(expert_replay, "dynamic_loading", False) else ""))
        if ep_stats_cfg and rollout is not None:
            rollout.episode_stats = EpisodicStatistics(rollout.num_envs, **ep_stats_cfg)
        if rollout is not None and n_steps > 0 and n_steps % rollout.num_envs != 0:
            raise ValueError(
                f"train_cfg.n_steps ({n_steps}) must be a multiple of the vec-env size "
                f"(rollout_cfg.num_procs = {rollout.num_envs}) for synchronized stepping"
            )
        log_trigger = EveryNSteps(n_log)
        eval_trigger = EveryNSteps(n_eval if n_eval and n_eval > 0 else None)
        ckpt_trigger = EveryNSteps(n_checkpoint if n_checkpoint and n_checkpoint > 0 else None)

        steps = resume_steps
        total_updates = 0
        log_trigger.reset(steps)
        if eval_trigger.n:
            eval_trigger.reset(steps)
        if ckpt_trigger.n:
            ckpt_trigger.reset(steps)

        metric_sums: Dict[str, float] = defaultdict(float)
        metric_counts: Dict[str, int] = defaultdict(int)
        time_sums: Dict[str, float] = defaultdict(float)
        vec_sum, vec_count = None, 0  # the updates' metric vectors, summed on the device
        follower = isinstance(rollout, ReplicaRollout)  # runs the chunks its host lead announces
        announce = getattr(rollout, "announce_updates", None)  # a host lead's
        if getattr(getattr(agent, "device", None), "type", None) == "cuda" and not agent.data_parallel.capturable:
            logger.info("Updates run eagerly, not as CUDA graphs: this rank's collectives go through gloo, on the "
                        "host, and a CUDA graph cannot capture them")

        # SIGTERM finishes the current cycle, then saves a numbered checkpoint
        # (model_final alone would auto-resume at step 0).
        stop = {"num": None}
        prev_term = None
        try:
            prev_term = signal.signal(signal.SIGTERM, lambda signum, frame: stop.__setitem__("num", signum))
            term_installed = True
        except ValueError:  # not the main thread
            term_installed = False

        # ---- warm-up: a fresh run prefills with random actions (and counts
        # them); a cold resume refills with the policy, off the step budget.
        if warm_steps > 0 and not on_policy and replay is not None and len(replay) == 0:
            assert rollout is not None
            warm_pi = None if resume_steps == 0 else agent
            warm = warm_steps
            if warm_pi is not None:
                warm = min(warm_steps, max(total_steps - resume_steps, 0))
                warm = -(-warm // rollout.num_envs) * rollout.num_envs
            if warm > 0:
                rollout.forward_with_policy(warm_pi, warm, replay)
                if warm_pi is None:
                    steps += warm
                    log_trigger.reset(steps)
                kind = "random" if warm_pi is None else "policy refill (cold resume, off-budget)"
                logger.info(f"Warm-up finished: {warm} {kind} steps, buffer size {len(replay)}")
                rollout.episode_stats.reset_current()

        profiler = _start_profiler(agent.device) if profile_steps > 0 and lead else None
        profile_until = steps + profile_steps

        def stop_agreed() -> bool:
            """Every rank's stop flag (SIGTERM), the same on all ranks: one
            collective per cycle, entered after the lead's own work."""
            local = allreduce_stats({"stop": 0.0 if stop["num"] is None else 1.0}, op="max")["stop"]
            if local > 0:
                stop["num"] = stop["num"] or signal.SIGTERM
            return local > 0

        begin_time = time.monotonic()
        begin_steps = steps
        while steps < total_steps and not stop_agreed():
            if watchdog is not None:
                watchdog.pet()
            iter_t0 = time.monotonic()
            if on_policy and replay is not None:
                replay.reset()
                if rollout is not None:
                    rollout.episode_stats.reset_current()

            # Interleaved updates (the JAX loop's update_hook): a chunk after
            # each act dispatch of the collection, sampling the buffer as it
            # stood before this cycle's push; the remainder after it.
            updates_dispatched = 0
            update_hook = None
            fused_active = False
            hook_s = 0.0
            can_interleave = (
                n_steps > 0 and n_updates > 1 and rollout is not None and replay is not None
                and hasattr(agent, "update_parameters_scan")
                and type(replay).__name__ == "DeviceReplayMemory" and len(replay) > 0
                and n_steps % rollout.num_envs == 0
            )
            if can_interleave:
                events = max((n_steps // rollout.num_envs) * rollout.pipeline_groups, 1)
                chunk = max(1, n_updates // events)
                fused_active = (not follower and act_fused_updates and hasattr(agent, "set_fused_updates")
                                and agent.set_fused_updates(replay, chunk, n_updates, announce=announce))

                def run_chunk(n):
                    nonlocal vec_sum, vec_count, total_updates, updates_dispatched, hook_s
                    t0 = time.monotonic()
                    agent.train()
                    vec = agent.update_parameters_scan(replay, n)
                    agent.eval()  # the rollout acts next
                    hook_s += time.monotonic() - t0
                    vec_sum = vec if vec_sum is None else vec_sum + vec
                    vec_count += n
                    total_updates += n
                    updates_dispatched += n

                if follower:  # when, and how many: the host lead says
                    update_hook = run_chunk
                elif not fused_active:

                    def update_hook():
                        if updates_dispatched + chunk > n_updates:
                            return
                        if announce is not None:
                            announce(chunk)
                        run_chunk(chunk)

            if n_steps > 0 and rollout is not None:
                agent.eval()
                out = rollout.forward_with_policy(agent, n_steps, replay, update_hook=update_hook,
                                                  recent_replay=recent_traj_replay)
                steps += n_steps
                if out and "_stats" in out:
                    for k, v in out["_stats"].items():
                        if k.endswith("_time"):
                            time_sums[k] += v
                time_sums["collect_sample_time"] += time.monotonic() - iter_t0 - hook_s
                time_sums["update_time"] += hook_s
            else:
                steps += 1  # offline mode progresses by update counting

            if fused_active:  # the chunks the explore acts took, summed on the device
                vec, done = agent.finish_fused_updates()
                if vec is not None:
                    vec_sum = vec if vec_sum is None else vec_sum + vec
                    vec_count += done
                    total_updates += done
                updates_dispatched += done

            update_t0 = time.monotonic()
            agent.train()
            if update_hook is not None or fused_active:
                left = n_updates - updates_dispatched
                if left > 0:  # the remainder the hook or the acts did not cover
                    vec = agent.update_parameters_scan(replay, left)
                    vec_sum = vec if vec_sum is None else vec_sum + vec
                    vec_count += left
                    total_updates += left
            elif hasattr(agent, "update_parameters_scan") and n_updates > 1:  # one program per cycle
                vec = agent.update_parameters_scan(replay, n_updates)
                vec_sum = vec if vec_sum is None else vec_sum + vec
                vec_count += n_updates
                total_updates += n_updates
            elif hasattr(agent, "update_parameters_lazy"):  # nothing waits for the device until log time
                for _ in range(n_updates):
                    total_updates += 1
                    vec = agent.update_parameters_lazy(replay, total_updates)
                    vec_sum = vec if vec_sum is None else vec_sum + vec
                    vec_count += 1
            else:
                for _ in range(n_updates):
                    total_updates += 1
                    metrics = agent.update_parameters(replay, total_updates)
                    for k, v in metrics.items():
                        metric_sums[k] += float(v)
                        metric_counts[k] += 1
            time_sums["update_time"] += time.monotonic() - update_t0

            if profiler is not None and steps >= profile_until:
                _stop_profiler(profiler, work_dir)
                profiler = None
                logger.info(f"Profiler trace written to {osp.join(work_dir, 'profile')}")

            # ---- logging ----------------------------------------------------
            if log_trigger.check(steps):
                if vec_sum is not None:
                    avg_metrics = agent.reduce_metric_vecs(vec_sum, vec_count)  # one device fetch
                    vec_sum, vec_count = None, 0
                else:
                    avg_metrics = {k: metric_sums[k] / max(metric_counts[k], 1) for k in metric_sums}
                env_stats = {}
                if rollout is not None:
                    if is_host_lead():  # the other ranks' rollouts collect nothing
                        env_stats = rollout.episode_stats.get_stats()
                    rollout.episode_stats.reset_history()
                    # every rank enters: the mean over the hosts' leads
                    env_stats = mean_over_hosts(env_stats)
                # the slowest rank's update time
                time_sums.update(allreduce_stats({"update_time": time_sums["update_time"]}, op="max"))
                elapsed = time.monotonic() - begin_time
                rate = (steps - begin_steps) / max(elapsed, 1e-9)
                eta = format_eta((total_steps - steps) / max(rate, 1e-9))
                diag = {
                    "buffer_size": len(replay) if replay is not None else 0,
                    "total_grad_steps": total_updates,
                    "samples_per_sec": rate,
                    "memory_mb": get_total_memory_mb(),
                    **time_sums,
                }
                logger.info(f"{steps}/{total_steps} ({steps / total_steps * 100:.0f}%) ETA {eta} | "
                            + dict_to_str({**env_stats, **avg_metrics}) + " | " + dict_to_str(diag))
                if exp_logger is not None:
                    exp_logger.log({**env_stats, **avg_metrics, **diag}, step=steps, tag="train")
                metric_sums.clear()
                metric_counts.clear()
                time_sums.clear()
                if recent_traj_replay is not None:
                    recent_traj_replay.reset()

            # ---- evaluation -------------------------------------------------
            if evaluator is not None and eval_trigger.n and eval_trigger.check(steps) and lead:
                std_step = eval_trigger.standard(steps)
                agent.eval()
                if watchdog is not None:
                    watchdog.pause()
                lens, rewards, finishes = evaluator.run(agent, num=eval_num,
                                                        work_dir=f"{work_dir}/eval_{std_step}")
                if watchdog is not None:
                    watchdog.resume()
                if exp_logger is not None:
                    exp_logger.log({"rewards_mean": float(np.mean(rewards)),
                                    "lengths_mean": float(np.mean(lens)),
                                    "success_rate": float(np.mean(finishes))}, step=std_step, tag="test")

            # ---- checkpoint -------------------------------------------------
            if ckpt_trigger.n and ckpt_trigger.check(steps) and lead:
                std_step = ckpt_trigger.standard(steps)
                path = save_checkpoint(agent.state_dict(), work_dir, std_step)
                logger.info(f"Saved checkpoint at step {std_step}: {path}")
                if save_replay > 0 and replay is not None:
                    t0 = time.monotonic()
                    n = save_replay_snapshot(replay, save_replay, work_dir)
                    logger.info(f"Saved replay snapshot ({n} transitions) in {time.monotonic() - t0:.1f} s")
        main_loop_s = time.monotonic() - begin_time
        if profiler is not None:
            _stop_profiler(profiler, work_dir)

        if lead and stop["num"] is not None and steps < total_steps:
            path = save_checkpoint(agent.state_dict(), work_dir, steps)
            logger.info(f"SIGTERM at {steps} steps; preemption checkpoint: {path}")
        if lead:
            path = save_checkpoint(agent.state_dict(), work_dir, steps, name="model_final")
            logger.info(f"Training finished at {steps} steps; final checkpoint: {path}")
        if term_installed:
            signal.signal(signal.SIGTERM, prev_term if prev_term is not None else signal.SIG_DFL)
        return {"steps": steps, "grad_steps": total_updates, "main_loop_s": main_loop_s,
                "main_loop_env_steps": steps - begin_steps}
    finally:
        if watchdog is not None:
            watchdog.stop()


def replay_snapshot(replay, num: int):
    """A host ``ReplayMemory`` of the ``min(num, len(replay))`` newest
    transitions of ``replay`` (a host or a device replay), in push order."""
    from ..env.replay import ReplayMemory

    num = min(num, len(replay))
    snap = ReplayMemory(capacity=num)
    snap.push_batch(replay.tail(num))
    return snap


def save_replay_snapshot(replay, num: int, work_dir: str) -> int:
    """Write ``replay_snapshot(replay, num)`` to
    ``<work_dir>/models/replay_latest.h5`` with lzf and return its length.
    The file is written under a temporary name and renamed into place, so a
    crash mid-write leaves the previous snapshot whole."""
    snap = replay_snapshot(replay, num)
    dst = osp.join(work_dir, "models", "replay_latest.h5")
    snap.to_hdf5(dst + ".tmp", compression="lzf")
    os.replace(dst + ".tmp", dst)
    return len(snap)


def _start_profiler(device):
    """A ``torch.profiler`` session of the host, and of the card when the
    agent is on one."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=acts)
    profiler.start()
    return profiler


def _stop_profiler(profiler, work_dir: str) -> None:
    """Stop, and write the trace as ``<work_dir>/profile/trace.json``
    (Chrome trace format: Perfetto, TensorBoard)."""
    profiler.stop()
    out = osp.join(work_dir, "profile")
    os.makedirs(out, exist_ok=True)
    profiler.export_chrome_trace(osp.join(out, "trace.json"))
