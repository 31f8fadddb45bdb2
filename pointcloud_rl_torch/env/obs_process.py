# Copy of pointcloud_rl_tpu/env/obs_process.py for the PyTorch port (that package's env imports JAX).
"""Observation-side point-cloud downsampling (host numpy path).

Parity target: reference ``pyrl/env/observation_process.py`` — ground
filtering, the seg-aware balanced sampler ``pcd_base`` (guaranteed minimum
points per segmentation mask, proportional foreground split, background
fill, pad-by-tiling), and uniform/voxel downsampling.  These run inside env
worker processes on the host; a vectorized jax variant lives in
``ops/sampling.py`` for on-device pipelines.

Note: these operate on channel-LAST single observations ([N, 3] / [N, K])
like the reference wrappers do before transposing to the channel-first env
output contract.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

PCD_KEYS = ("xyz", "rgb", "seg", "inst_seg", "target_seg")


def sample_and_pad(n: int, num: int, np_random: Optional[np.random.RandomState] = None, pad: bool = True) -> np.ndarray:
    """Random index subset of size num; when n < num, tile indices to pad
    (reference array_ops.py:969-983)."""
    rng = np_random or np.random
    if n == 0:
        return np.zeros(num, np.int64)
    index = np.arange(n)
    if n > num:
        rng.shuffle(index)
        index = index[:num]
    elif n < num and pad:
        reps = num // n
        index = np.concatenate([index] * reps + [index[: num - n * reps]])
    return index


def _select(obs: Dict[str, np.ndarray], mask) -> None:
    for key in PCD_KEYS:
        if key in obs:
            obs[key] = obs[key][mask]


def pcd_filter_ground(obs: Dict[str, np.ndarray], eps: float = 1e-3) -> np.ndarray:
    return obs["xyz"][..., 2] > eps


def pcd_base(
    obs: Dict[str, np.ndarray],
    n_points: int = 1200,
    min_pts: int = 50,
    fg_pts: int = 800,
    np_random: Optional[np.random.RandomState] = None,
    use_native: Optional[bool] = None,
) -> Dict[str, np.ndarray]:
    """Seg-aware balanced downsampling (reference observation_process.py:29-70).

    1. Drop ground points (z <= 1e-3).
    2. Guarantee each seg mask min(count, min_pts) points, then split the
       remaining foreground budget proportionally to leftover counts.
    3. Fill the rest of the budget with background points.
    4. If the selection is short, tile indices up to n_points.
    """
    rng = np_random or np.random
    if use_native is None or use_native:
        from ..native import available, seg_balanced_sample_indices

        if available() and "seg" in obs and (use_native or use_native is None):
            seed = int(rng.randint(2**31)) if hasattr(rng, "randint") else 0
            idx = seg_balanced_sample_indices(
                np.ascontiguousarray(obs["xyz"], np.float32),
                np.ascontiguousarray(obs["seg"]).astype(np.uint8),
                n_points, min_pts, fg_pts, seed,
            )
            _select(obs, idx)
            return obs
    _select(obs, obs["xyz"][:, 2] > 1e-3)

    seg = obs["seg"]
    num_pts = seg.sum(0)
    base_num = np.minimum(num_pts, min_pts)
    remain = num_pts - base_num
    denom = max(int(remain.sum()), 1)
    tgt_pts = base_num + (fg_pts - base_num.sum()) * remain // denom
    back_pts = n_points - tgt_pts.sum()

    bg = ~seg.any(-1, keepdims=True)
    seg_all = np.concatenate([seg, bg], axis=-1)
    budget = np.concatenate([tgt_pts, [back_pts]])
    counts = seg_all.sum(0)

    chosen = []
    for i in range(seg_all.shape[1]):
        if counts[i] == 0:
            continue
        idx = np.where(seg_all[:, i])[0]
        rng.shuffle(idx)
        chosen.append(idx[: budget[i]])
    chosen = np.concatenate(chosen) if chosen else np.zeros(1, np.int64)

    if len(chosen) < n_points:
        reps = n_points // len(chosen)
        chosen = np.concatenate([chosen] * reps + [chosen[: n_points % len(chosen)]])
    _select(obs, chosen)
    return obs


def pcd_uniform_downsample(
    obs: Dict[str, np.ndarray], ground_eps: Optional[float] = 1e-3, num: int = 1200,
    np_random: Optional[np.random.RandomState] = None,
) -> Dict[str, np.ndarray]:
    if ground_eps is not None:
        _select(obs, pcd_filter_ground(obs, ground_eps))
    _select(obs, sample_and_pad(obs["xyz"].shape[0], num, np_random))
    return obs


def pcd_voxel_downsample(
    obs: Dict[str, np.ndarray], ground_eps: Optional[float] = 1e-3, num: int = 1200,
    voxel_size: float = 0.02, np_random: Optional[np.random.RandomState] = None,
) -> Dict[str, np.ndarray]:
    """Keep one random point per voxel, then uniform downsample
    (reference observation_process.py:118-138)."""
    rng = np_random or np.random
    if ground_eps is not None:
        _select(obs, pcd_filter_ground(obs, ground_eps))
    index = np.arange(obs["xyz"].shape[0])
    rng.shuffle(index)
    v = (obs["xyz"][index] // voxel_size).astype(np.int64)
    v -= v.min(0)
    extent = v.max(0) + 1
    key = v[:, 0] + v[:, 1] * extent[0] + v[:, 2] * extent[0] * extent[1]
    unique_idx = np.unique(key, return_index=True)[1]
    _select(obs, index[unique_idx])
    return pcd_uniform_downsample(obs, None, num, rng)
