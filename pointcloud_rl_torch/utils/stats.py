# Copy of pointcloud_rl_tpu/utils/stats.py (the parts the port calls) for the PyTorch port, which imports nothing of that package.
"""Running statistics and interval triggers.

Covers the reference's pyrl/utils/math/{counting,running_stats}.py and the
EpisodicStatistics accumulator from pyrl/apis/train_rl.py, rebuilt for a
jax-first stack (all host-side numpy; cross-process reduction happens via
the parallel package, not here).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional

import numpy as np


class EveryNSteps:
    """Fire once each time the step counter crosses a multiple of n."""

    def __init__(self, n: Optional[int]):
        self.n = n
        self.last = 0

    def reset(self, start: int = 0) -> None:
        self.last = start // self.n if self.n else 0

    def check(self, step: int) -> bool:
        if not self.n or self.n <= 0:
            return False
        if step // self.n > self.last:
            self.last = step // self.n
            return True
        return False

    def standard(self, step: int) -> int:
        """The canonical step of the most recent trigger (multiple of n)."""
        return (step // self.n) * self.n if self.n else step


class EpisodicStatistics:
    """Per-worker running episode returns/lengths with min/mean/max summaries.

    Mirrors reference pyrl/apis/train_rl.py:15-110: rewards accumulate per env
    worker; on episode done the totals are pushed into history; ``get_stats``
    reduces the history since the last ``reset_history``.

    ``info_keys_mode`` adds configurable per-episode reductions over info-dict
    scalars (reference train_rl.py:16-24,44-56): ``{key: [print, episode_op,
    log_mode]}`` with ``episode_op`` in {sum, mean, min, max} applied across
    the episode's steps and ``log_mode`` in {"all", "mean"} choosing whether
    min/max also log.  This is how ManiSkill-style success rates reach the
    training logs (``env/success_mean``).
    """

    def __init__(self, num_workers: int, info_keys_mode: Optional[Dict[str, list]] = None):
        self.num_workers = num_workers
        self.info_keys_mode: Dict[str, list] = dict(info_keys_mode or {})
        for key, item in self.info_keys_mode.items():
            assert item[1] in ("mean", "min", "max", "sum"), f"bad episode op for {key}: {item[1]}"
            assert item[2] in ("mean", "all"), f"bad log mode for {key}: {item[2]}"
        self.current_rewards = np.zeros(num_workers, np.float64)
        self.current_lens = np.zeros(num_workers, np.int64)
        self.current_max_reward = np.full(num_workers, -np.inf)
        self.current_infos: List[Dict[str, float]] = [dict() for _ in range(num_workers)]
        self.history_rewards: List[float] = []
        self.history_lens: List[int] = []
        self.history_infos: Dict[str, List[float]] = defaultdict(list)
        self.num_episodes = 0
        self._last_stats: Optional[Dict[str, float]] = None

    def _accumulate_info(self, worker: int, infos: Optional[Dict[str, Any]], row: int) -> None:
        if not self.info_keys_mode or not infos:
            return
        cur = self.current_infos[worker]
        for key, (_, op, _) in self.info_keys_mode.items():
            if key not in infos:
                continue
            v = float(np.asarray(infos[key][row]).reshape(-1)[0])
            if op in ("sum", "mean"):
                cur[key] = cur.get(key, 0.0) + v
            elif op == "min":
                cur[key] = min(cur.get(key, np.inf), v)
            else:
                cur[key] = max(cur.get(key, -np.inf), v)

    def _finish_episode(self, worker: int) -> None:
        self.history_rewards.append(float(self.current_rewards[worker]))
        self.history_lens.append(int(self.current_lens[worker]))
        cur = self.current_infos[worker]
        for key, value in cur.items():
            if self.info_keys_mode[key][1] == "mean":
                value = value / max(int(self.current_lens[worker]), 1)
            self.history_infos[key].append(value)
        self.current_infos[worker] = dict()
        self.current_rewards[worker] = 0
        self.current_lens[worker] = 0
        self.current_max_reward[worker] = -np.inf
        self.num_episodes += 1

    def push(self, rewards: np.ndarray, episode_dones: np.ndarray, infos: Optional[Dict[str, Any]] = None) -> int:
        """Accumulate one vec-env step; returns the number of episodes finished."""
        rewards = np.asarray(rewards).reshape(self.num_workers)
        dones = np.asarray(episode_dones).reshape(self.num_workers).astype(bool)
        self.current_rewards += rewards
        self.current_lens += 1
        self.current_max_reward = np.maximum(self.current_max_reward, rewards)
        if self.info_keys_mode and infos:
            for i in range(self.num_workers):
                self._accumulate_info(i, infos, i)
        n_done = int(dones.sum())
        if n_done:
            for i in np.nonzero(dones)[0]:
                self._finish_episode(int(i))
        return n_done

    def push_single(self, worker: int, reward: float, episode_done: bool,
                    infos: Optional[Dict[str, Any]] = None, row: int = 0) -> int:
        """Accumulate one transition for one worker (warm-up/pipelined batches)."""
        self.current_rewards[worker] += reward
        self.current_lens[worker] += 1
        self.current_max_reward[worker] = max(self.current_max_reward[worker], reward)
        self._accumulate_info(worker, infos, row)
        if episode_done:
            self._finish_episode(worker)
            return 1
        return 0

    def reset_history(self) -> None:
        self.history_rewards.clear()
        self.history_lens.clear()
        self.history_infos.clear()

    def reset_current(self) -> None:
        self.current_rewards[:] = 0
        self.current_lens[:] = 0
        self.current_max_reward[:] = -np.inf
        self.current_infos = [dict() for _ in range(self.num_workers)]

    def get_stats(self) -> Dict[str, float]:
        if not self.history_rewards and self._last_stats is not None:
            # Synchronized-episode envs (e.g. walker's fixed 1000-step
            # episodes across all workers) complete episodes only every
            # episode_len * num_workers global steps; log windows between
            # completions would otherwise read 0.0 (the reference never logs
            # such windows — it gates its log boundary on >= print_steps
            # completions, pyrl/apis/train_rl.py:270).  Carry the last
            # completed-window values forward, with num_episodes=0 marking
            # the window as stale.
            return {**self._last_stats, "env/num_episodes": 0.0}
        r = np.asarray(self.history_rewards if self.history_rewards else [0.0])
        l = np.asarray(self.history_lens if self.history_lens else [0])
        stats = {
            "env/rewards_mean": float(r.mean()),
            "env/rewards_min": float(r.min()),
            "env/rewards_max": float(r.max()),
            "env/episode_length": float(l.mean()),
            "env/num_episodes": float(len(self.history_rewards)),
        }
        for key, (_, _, log_mode) in self.info_keys_mode.items():
            vals = self.history_infos.get(key)
            if not vals:
                continue
            v = np.asarray(vals, np.float64)
            out_key = key if "/" in key else f"env/{key}"
            stats[f"{out_key}_mean"] = float(v.mean())
            if log_mode == "all":
                stats[f"{out_key}_min"] = float(v.min())
                stats[f"{out_key}_max"] = float(v.max())
        if self.history_rewards:
            self._last_stats = dict(stats)
        return stats


def split_num(total: int, parts: int) -> List[int]:
    """Split ``total`` into ``parts`` near-equal integers (front-loaded)."""
    base, rem = divmod(total, parts)
    return [base + (1 if i < rem else 0) for i in range(parts)]
