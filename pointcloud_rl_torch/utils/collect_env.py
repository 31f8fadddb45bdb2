# Copy of pointcloud_rl_tpu/utils/collect_env.py (torch versions in place of JAX's) for the PyTorch port, which imports nothing of that package.
"""Environment/hardware report for run logs (reference collect_env.py role)."""

from __future__ import annotations

import platform
import subprocess
import sys
from typing import Dict


def collect_env_info() -> Dict[str, str]:
    info = {
        "python": sys.version.split()[0],
        "platform": platform.platform(),
    }
    for mod in ("torch", "numpy"):
        try:
            info[mod] = __import__(mod).__version__
        except Exception:
            info[mod] = "unavailable"
    try:
        import torch

        info["cuda"] = str(torch.version.cuda)
        if torch.cuda.is_available():
            info["cuda_devices"] = ", ".join(torch.cuda.get_device_name(i)
                                             for i in range(torch.cuda.device_count()))
    except Exception as e:
        info["cuda"] = f"error: {e}"
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True, timeout=5)
        info["git_commit"] = out.stdout.strip()[:12] if out.returncode == 0 else "n/a"
        dirty = subprocess.run(["git", "status", "--porcelain"], capture_output=True, text=True, timeout=5)
        info["git_clean"] = "yes" if (dirty.returncode == 0 and not dirty.stdout.strip()) else "no"
    except Exception:
        info["git_commit"] = "n/a"
    return info


def check_reproducibility(strict: bool = False) -> bool:
    """True when the working tree is clean (reference collect_env.py:139)."""
    info = collect_env_info()
    clean = info.get("git_clean") == "yes"
    if strict and not clean:
        raise RuntimeError("Reproducible runs require a clean git tree")
    return clean
