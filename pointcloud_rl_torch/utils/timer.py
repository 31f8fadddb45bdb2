# Copy of pointcloud_rl_tpu/utils/timer.py (the parts the port calls) for the PyTorch port, which imports nothing of that package.
"""The trainer's ETA string.  The port's host timings are the spans of
``utils/trace.py``."""

from __future__ import annotations


def format_eta(seconds: float) -> str:
    seconds = int(max(seconds, 0))
    d, rem = divmod(seconds, 86400)
    h, rem = divmod(rem, 3600)
    m, s = divmod(rem, 60)
    if d:
        return f"{d}d {h:02d}:{m:02d}:{s:02d}"
    return f"{h:02d}:{m:02d}:{s:02d}"
