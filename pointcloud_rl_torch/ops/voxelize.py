"""Point-cloud voxelization (port of ``pointcloud_rl_tpu/ops/voxelize.py``).

Two strategies, both with static output shapes:

* ``voxelize_dense``: scatter-mean points into a fixed ``[B, Gx, Gy, Gz, C]``
  grid plus its occupancy (the dense path of ``models/voxel.py``).
* ``voxelize_sparse``: dedupe occupied voxels into ``capacity`` slots by a
  stable sort of int32 voxel keys, with per-voxel mean features, integer
  coordinates and a validity mask (the sparse path's input).

On a CUDA tensor the scatters are ``index_add_`` with atomics, so the sum
order, and so the last ulp of a voxel mean, may differ from run to run.
None of these is a hand kernel; they are XLA ops in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

INT32_MAX = torch.iinfo(torch.int32).max


def compute_voxel_coords(xyz: torch.Tensor, voxel_size: float, origin: Optional[torch.Tensor] = None,
                         grid_size: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Integer voxel coordinates per point, ``[..., N, 3]`` int32.

    With no explicit origin each cloud is shifted by its own min corner (no
    gradient flows through the shift); with ``grid_size`` the coordinates
    are clipped into the grid."""
    if origin is None:
        origin = xyz.detach().amin(dim=-2, keepdim=True)
    coords = torch.floor((xyz - origin) / voxel_size).to(torch.int32)
    if grid_size is not None:
        top = torch.tensor([int(g) - 1 for g in grid_size], dtype=torch.int32, device=xyz.device)
        coords = torch.minimum(coords.clamp_min(0), top)
    return coords


def voxelize_dense(xyz: torch.Tensor, features: torch.Tensor, voxel_size: float, grid_size: Sequence[int],
                   origin: Optional[torch.Tensor] = None,
                   valid_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter-mean ``features`` [B, N, C] into ``[B, Gx, Gy, Gz, C]``
    (0 where empty) and the occupancy ``[B, Gx, Gy, Gz]`` bool.  Invalid
    points (``valid_mask`` [B, N] false) go to voxel 0 with weight 0."""
    B, N, _ = xyz.shape
    C = features.shape[-1]
    gx, gy, gz = (int(g) for g in grid_size)
    coords = compute_voxel_coords(xyz, voxel_size, origin, grid_size).long()
    flat = (coords[..., 0] * gy + coords[..., 1]) * gz + coords[..., 2]  # [B, N]
    if valid_mask is not None:
        flat = torch.where(valid_mask, flat, 0)
        w = valid_mask.to(features.dtype)
    else:
        w = torch.ones((B, N), dtype=features.dtype, device=features.device)
    num_vox = gx * gy * gz
    flat = (flat + torch.arange(B, device=flat.device)[:, None] * num_vox).reshape(-1)
    sums = features.new_zeros((B * num_vox, C)).index_add_(0, flat, (features * w[..., None]).reshape(-1, C))
    counts = features.new_zeros((B * num_vox,)).index_add_(0, flat, w.reshape(-1))
    mean = sums / counts.clamp_min(1.0)[:, None]
    return mean.reshape(B, gx, gy, gz, C), (counts > 0).reshape(B, gx, gy, gz)


def _segment_ranks(sorted_key: torch.Tensor, capacity: int):
    """Per sorted key (int32, ``INT32_MAX`` = invalid): its segment's slot,
    ``capacity`` for overflow or invalid keys, and the number of segments."""
    valid = sorted_key != INT32_MAX
    is_start = torch.ones_like(valid)
    is_start[..., 1:] = sorted_key[..., 1:] != sorted_key[..., :-1]
    is_start &= valid
    rank = torch.cumsum(is_start, dim=-1) - 1
    rank = torch.where(valid, rank.clamp_max(capacity - 1), capacity)
    return rank, is_start.sum(dim=-1)


def _scatter_slots(rank: torch.Tensor, values: torch.Tensor, capacity: int, reduce: str) -> torch.Tensor:
    """``values`` [B, N, C] reduced into ``capacity + 1`` slots per row by
    ``rank`` [B, N] (slot ``capacity`` collects what is dropped)."""
    B, _, C = values.shape
    out = values.new_zeros((B, capacity + 1, C))
    index = rank[..., None].expand(-1, -1, C)
    if reduce == "sum":
        return out.scatter_add(1, index, values)
    return out.scatter_reduce(1, index, values, reduce="amax", include_self=True)


def voxelize_sparse(xyz: torch.Tensor, features: torch.Tensor, voxel_size: float, capacity: int,
                    origin: Optional[torch.Tensor] = None, valid_mask: Optional[torch.Tensor] = None):
    """Dedupe points into at most ``capacity`` voxel slots, in key order.

    Returns voxel_feat [B, M, C] (the mean feature per occupied voxel, 0
    padded), voxel_coords [B, M, 3] int32 (0 padded) and voxel_valid [B, M].
    Keys are int32 with 10 bits per axis (coordinates clipped to 1022);
    voxels past ``capacity`` are dropped."""
    M = int(capacity)
    coords = compute_voxel_coords(xyz, voxel_size, origin)
    c = coords.clamp(0, 1022)
    key = (c[..., 0] << 20) | (c[..., 1] << 10) | c[..., 2]
    if valid_mask is not None:
        key = torch.where(valid_mask, key, INT32_MAX)
    order = torch.argsort(key, dim=-1, stable=True)
    ks = torch.gather(key, 1, order)
    cs = torch.gather(coords, 1, order[..., None].expand(-1, -1, 3))
    fs = torch.gather(features, 1, order[..., None].expand(-1, -1, features.shape[-1]))
    rank, n_vox = _segment_ranks(ks, M)
    sums = _scatter_slots(rank, fs, M, "sum")[:, :M]
    counts = _scatter_slots(rank, torch.ones_like(fs[..., :1]), M, "sum")[:, :M]
    vcoords = _scatter_slots(rank, cs, M, "amax")[:, :M]
    slot_valid = torch.arange(M, device=xyz.device) < n_vox.clamp_max(M)[:, None]
    mean = sums / counts.clamp_min(1.0)
    return mean * slot_valid[..., None], vcoords * slot_valid[..., None], slot_valid
