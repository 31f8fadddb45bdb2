# Copy of pointcloud_rl_tpu/utils/seeding.py (without the JAX compile-cache helper) for the PyTorch port, which imports nothing of that package.
"""Seeding and process-level environment defaults.

Mirrors the reference's init discipline (pyrl/apis/run_rl.py:248-273 and
pyrl/utils/meta/env_var.py): per-rank seeds ``seed + rank``, single-threaded
BLAS for env worker processes, and MUJOCO_GL selection — the device RNG
of the port is a torch.Generator seeded from the same seed.
"""

from __future__ import annotations

import os
import random
from typing import Optional

import numpy as np


def add_env_vars(single_thread_blas: bool = True) -> None:
    """Set library env defaults before heavy imports (idempotent)."""
    if single_thread_blas:
        for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS", "NUMEXPR_NUM_THREADS"):
            os.environ.setdefault(var, "1")
    os.environ.setdefault("MUJOCO_GL", "egl")


def set_host_seed(seed: Optional[int]) -> Optional[int]:
    """Seed python/numpy host RNGs; returns the seed used."""
    if seed is None:
        seed = int.from_bytes(os.urandom(4), "little")
    random.seed(seed)
    np.random.seed(seed % (2**32))
    return seed


def worker_seed(base_seed: int, rank: int, worker_index: int = 0, num_workers: int = 1) -> int:
    """Deterministic distinct seed per (rank, env worker)."""
    return int(base_seed) + rank * max(num_workers, 1) + worker_index
