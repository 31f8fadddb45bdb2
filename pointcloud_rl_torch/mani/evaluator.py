# Copy of pointcloud_rl_tpu/mani/evaluator.py for the PyTorch port, which imports nothing of that package.
"""Challenge-style evaluation harness for manipulation benchmarks.

Parity target: reference ``mani_skill/mani_skill/eval/evaluator.py`` and the
``BasePolicy``/``UserPolicy`` plugin protocol (``user_solution.py``): run a
policy over a fixed list of level seeds, count each key of the env's
``info["eval_info"]`` dict at episode end, and export per-env success rates
to CSV.
"""

from __future__ import annotations

import csv
from collections import OrderedDict, defaultdict
from typing import Dict, List, Optional, Sequence

from ..utils.logger import get_logger


class BasePolicy:
    """Plugin protocol for challenge submissions (user_solution.py:7-39)."""

    obs_mode: str = "pointcloud"

    def reset(self) -> None:  # called before each episode
        pass

    def act(self, observation):
        raise NotImplementedError


class Evaluator:
    """Run ``policy`` over fixed level seeds and reduce eval_info flags.

    ``env`` may be passed directly, or built from ``env_name`` via the
    framework's env builder (which covers FakeManipulationEnv and, when
    SAPIEN is installed, real ManiSkill tasks).
    """

    def __init__(self, env_name: Optional[str] = None, policy: Optional[BasePolicy] = None,
                 env=None, env_cfg: Optional[dict] = None):
        assert policy is not None, "Evaluator needs a policy"
        self.policy = policy
        self.env_name = env_name or "<custom env>"
        if env is None:
            from ..env.builder import build_env

            cfg = dict(env_cfg or {})
            cfg.setdefault("type", "gym")
            cfg["env_name"] = env_name
            cfg.setdefault("obs_mode", getattr(policy, "obs_mode", "pointcloud"))
            env = build_env(cfg)
        self.env = env
        self.result: Dict[str, float] = OrderedDict()
        self.logger = get_logger("pcrl.mani_eval")

    def run(self, level_list: Sequence[int], max_steps: int = 10000) -> Dict[str, float]:
        counts = defaultdict(int)
        for level in level_list:
            self.policy.reset()
            obs = self.env.reset(level=int(level))
            for _ in range(max_steps):
                obs, reward, done, info = self.env.step(self.policy.act(obs))
                if done:
                    eval_info = info.get("eval_info")
                    if eval_info is None:
                        raise RuntimeError(
                            "episode ended without info['eval_info'] — the env must "
                            "report eval flags at done (reference evaluator.py:35-39)"
                        )
                    for key, value in eval_info.items():
                        counts[key] += int(value)
                    break
            else:
                raise RuntimeError(f"episode exceeded {max_steps} steps without done")
        self.result = OrderedDict((k, v / max(len(level_list), 1)) for k, v in counts.items())
        return self.result

    def export_to_csv(self, path: str = "./eval_results.csv") -> None:
        headers = ["env"] + list(self.result.keys())
        row = [self.env_name] + [f"{v:.4f}" for v in self.result.values()]
        with open(path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(headers)
            writer.writerow(row)
        self.logger.info("eval result %s -> %s", dict(self.result), path)

    def close(self) -> None:
        if hasattr(self.env, "close"):
            self.env.close()
