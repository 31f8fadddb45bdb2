# Copy of pointcloud_rl_tpu/utils/process.py for the PyTorch port, which imports nothing of that package.
"""Process telemetry (reference get_total_memory, process_utils.py:14):
RSS of this process plus all children, without psutil (procfs parsing)."""

from __future__ import annotations

import os
from typing import List


def _rss_kb(pid: int) -> int:
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except (FileNotFoundError, ProcessLookupError, PermissionError):
        pass
    return 0


def _children(pid: int) -> List[int]:
    out: List[int] = []
    try:
        with open(f"/proc/{pid}/task/{pid}/children") as f:
            out = [int(x) for x in f.read().split()]
    except (FileNotFoundError, PermissionError):
        pass
    return out


def get_total_memory_mb(pid: int | None = None) -> float:
    """RSS in MB of the process tree rooted at pid (default: this process)."""
    root = pid or os.getpid()
    seen, stack, total_kb = set(), [root], 0
    while stack:
        p = stack.pop()
        if p in seen:
            continue
        seen.add(p)
        total_kb += _rss_kb(p)
        stack.extend(_children(p))
    return total_kb / 1024.0
