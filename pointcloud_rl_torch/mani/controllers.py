# Copy of pointcloud_rl_tpu/mani/controllers.py for the PyTorch port, which imports nothing of that package.
"""Per-joint controller stack for manipulation agents.

Parity target: reference ``mani_skill/mani_skill/agent/controllers.py`` (the
LPFilter/PID/velocity/position controller classes) and the YAML-driven stack
construction in ``agent.py:159-193``.  Behavior-defining details kept:

- LPFilter coefficient derives from the bilinear low-pass design
  ``alpha = -yc + sqrt(yc^2 + 2 yc)`` with ``yc = 1 - cos(wc dt)``;
- the PID derivative term treats the first call's previous error as the
  current error (zero D kick on the first control step);
- integral accumulates AFTER the output is computed;
- PositionController = PID(position -> velocity) then optional low-pass.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class LPFilter:
    """First-order discrete low-pass filter with the reference's coefficient
    design (controllers.py:4-14)."""

    def __init__(self, control_freq: float, cutoff_freq: float):
        dt = 1.0 / control_freq
        wc = 2.0 * np.pi * cutoff_freq
        yc = 1.0 - np.cos(wc * dt)
        self.alpha = -yc + np.sqrt(yc * yc + 2.0 * yc)
        self.y = 0.0

    def next(self, x: float) -> float:
        self.y = self.y + self.alpha * (x - self.y)
        return self.y

    def reset(self) -> None:
        self.y = 0.0


class PIDController:
    """Positional PID with clamped output (controllers.py:17-88)."""

    def __init__(self, kp: float, ki: float, kd: float, control_freq: float, output_range):
        self.kp, self.ki, self.kd = kp, ki, kd
        self.dt = 1.0 / control_freq
        self.output_range = tuple(output_range)
        self.reset()

    def reset(self) -> None:
        self._prev_err = None
        self._cum_err = 0.0

    def control(self, current: float, target: float) -> float:
        err = target - current
        if self._prev_err is None:
            self._prev_err = err
        value = self.kp * err + self.kd * (err - self._prev_err) / self.dt + self.ki * self._cum_err
        self._prev_err = err
        self._cum_err += self.dt * err
        return float(np.clip(value, self.output_range[0], self.output_range[1]))


class VelocityController:
    """Velocity pass-through with optional low-pass smoothing
    (controllers.py:91-107)."""

    def __init__(self, lp_filter: Optional[LPFilter] = None):
        self.lp_filter = lp_filter

    def control(self, current: float, target: float) -> float:
        if self.lp_filter is None:
            return target
        return self.lp_filter.next(target)


class PositionController:
    """Position target -> PID velocity command -> optional low-pass
    (controllers.py:110-130)."""

    def __init__(self, velocity_pid: PIDController, lp_filter: Optional[LPFilter] = None):
        self.velocity_pid = velocity_pid
        self.lp_filter = lp_filter

    def control(self, current: float, target: float) -> float:
        v = self.velocity_pid.control(current, target)
        if self.lp_filter is not None:
            v = self.lp_filter.next(v)
        return v

    def reset(self) -> None:
        self.velocity_pid.reset()
        if self.lp_filter is not None:
            self.lp_filter.reset()


def build_joint_controllers(joint_cfgs: List[dict], control_freq: float) -> Tuple[list, np.ndarray]:
    """Build one controller per controllable joint from YAML joint specs
    (reference agent.py:159-193).

    Each spec carries ``action_type`` ("velocity" | "position"),
    ``action_range`` [low, high], optional ``velocity_filter:
    {cutoff_frequency}`` and, for position joints, ``velocity_pid:
    {kp, ki, kd, limit}``.  Returns (controllers, action_range [N, 2]).
    """
    controllers = []
    ranges = []
    for joint in joint_cfgs:
        ranges.append(joint["action_range"])
        lp = None
        if "velocity_filter" in joint:
            lp = LPFilter(control_freq, joint["velocity_filter"]["cutoff_frequency"])
        action_type = joint["action_type"]
        if action_type == "velocity":
            controllers.append(VelocityController(lp))
        elif action_type == "position":
            pid = joint["velocity_pid"]
            controllers.append(PositionController(
                PIDController(pid["kp"], pid["ki"], pid["kd"], control_freq, pid["limit"]), lp
            ))
        else:
            raise ValueError(f"action_type must be velocity|position, got {action_type!r}")
    return controllers, np.asarray(ranges, np.float32)
