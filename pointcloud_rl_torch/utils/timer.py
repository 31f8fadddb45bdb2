# Copy of pointcloud_rl_tpu/utils/timer.py (the parts the port calls) for the PyTorch port, which imports nothing of that package.
"""Named-segment wall-clock timer (reference pyrl/utils/meta/timer.py semantics).

Drives the rollout's simulation/agent/copy/overhead breakdown and the
trainer's episode/collect/update time log lines.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, Optional


class Timer:
    """Accumulates wall-clock time into named segments between ticks."""

    def __init__(self):
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        self._last = time.monotonic()
        self._start = self._last

    def reset(self) -> None:
        self._totals.clear()
        self._counts.clear()
        self._last = time.monotonic()
        self._start = self._last

    def tick(self, name: str) -> float:
        """Charge the time since the previous tick to segment ``name``."""
        now = time.monotonic()
        dt = now - self._last
        self._totals[name] += dt
        self._counts[name] += 1
        self._last = now
        return dt

    def skip(self) -> None:
        """Advance the reference point without charging any segment."""
        self._last = time.monotonic()

    def add(self, name: str, seconds: float) -> None:
        """Charge externally measured time to a segment."""
        self._totals[name] += seconds
        self._counts[name] += 1
        self._last = time.monotonic()

    def total(self, name: Optional[str] = None) -> float:
        if name is None:
            return time.monotonic() - self._start
        return self._totals[name]

    def todict(self) -> Dict[str, float]:
        return dict(self._totals)

    def summary(self, precision: int = 3) -> str:
        total = sum(self._totals.values())
        parts = [f"{k}: {v:.{precision}f}s" for k, v in sorted(self._totals.items())]
        return ", ".join(parts) + f" (total {total:.{precision}f}s)"


def format_eta(seconds: float) -> str:
    seconds = int(max(seconds, 0))
    d, rem = divmod(seconds, 86400)
    h, rem = divmod(rem, 3600)
    m, s = divmod(rem, 60)
    if d:
        return f"{d}d {h:02d}:{m:02d}:{s:02d}"
    return f"{h:02d}:{m:02d}:{s:02d}"
