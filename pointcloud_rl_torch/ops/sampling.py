"""Batched point-cloud downsampling on the device.

Port of ``pointcloud_rl_tpu/ops/sampling.py``: ``pcd_base`` semantics
(ground filter, a guaranteed minimum per segmentation mask, a proportional
foreground split, background fill, pad-by-tiling) over a whole batch with
static shapes, each group's members ranked by a randomized stable sort.

Randomness: the uniforms come from a ``torch.Generator`` on the data's
device or are passed in as ``draws``: ``seg_balanced_downsample`` takes
``(rank [B, N, K+1], order [B, N])``, ``uniform_downsample`` ``[B, N]``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_BIG = 1e9


def _tile_members(order: torch.Tensor, n_members: torch.Tensor, n_points: int) -> torch.Tensor:
    """The first ``n_points`` of each row of ``order``, tiled over its
    ``n_members`` leading entries (at least one), as int32."""
    pos = torch.arange(n_points, device=order.device)[None, :]
    return order.gather(1, pos % n_members.clamp_min(1)[:, None]).to(torch.int32)


def seg_balanced_downsample(xyz: torch.Tensor, seg: torch.Tensor, n_points: int, min_pts: int = 50,
                            fg_pts: int = 800, ground_eps: float = 1e-3, generator: Optional[torch.Generator] = None,
                            draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """Choose ``n_points`` indices per cloud (pcd_base semantics, batched).

    Args:
      xyz: ``[B, N, 3]`` channel-last points.
      seg: ``[B, N, K]`` boolean masks.
    Returns:
      indices ``[B, n_points]`` int32 into the N axis (tiled when short).
    """
    B, N, _ = xyz.shape
    K = seg.shape[-1]
    if draws is None:
        draws = (torch.rand((B, N, K + 1), generator=generator, device=xyz.device),
                 torch.rand((B, N), generator=generator, device=xyz.device))
    rand, rand2 = draws
    keep = xyz[..., 2] > ground_eps  # [B, N]
    seg = seg.bool() & keep[..., None]
    bg = keep & ~seg.any(-1)
    groups = torch.cat([seg, bg[..., None]], dim=-1)  # [B, N, K+1]

    # budgets (observation_process.py:41-51)
    counts = groups[..., :K].sum(dim=1)  # [B, K]
    base = counts.clamp_max(min_pts)
    remain = counts - base
    denom = remain.sum(-1, keepdim=True).clamp_min(1)
    tgt = base + (fg_pts - base.sum(-1, keepdim=True)) * remain // denom  # [B, K]
    back = n_points - tgt.sum(-1, keepdim=True)
    budgets = torch.minimum(torch.cat([tgt, back], dim=-1), groups.sum(dim=1))  # capped by availability

    # each point's rank in its group, in a random order: rank < budget => selected
    order = torch.argsort(torch.where(groups, rand, torch.full_like(rand, _BIG)), dim=1, stable=True)
    iota = torch.arange(N, device=xyz.device)[None, :, None].expand_as(order)
    rank = torch.empty_like(order).scatter_(1, order, iota)
    selected_any = (groups & (rank < budgets[:, None, :])).any(-1)  # [B, N]

    # the selected points first, in a random order, then tiled
    order2 = torch.argsort(torch.where(selected_any, rand2, _BIG + rand2), dim=1, stable=True)
    return _tile_members(order2, selected_any.sum(-1), n_points)


def uniform_downsample(xyz: torch.Tensor, n_points: int, ground_eps: Optional[float] = 1e-3,
                       generator: Optional[torch.Generator] = None,
                       draws: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A uniform random subset with pad-by-tiling (pcd_uniform_downsample);
    points at or below ``ground_eps`` are left out unless it is None."""
    B, N, _ = xyz.shape
    valid = xyz[..., 2] > ground_eps if ground_eps is not None else torch.ones((B, N), dtype=torch.bool,
                                                                                device=xyz.device)
    rand = torch.rand((B, N), generator=generator, device=xyz.device) if draws is None else draws
    order = torch.argsort(torch.where(valid, rand, _BIG + rand), dim=1, stable=True)
    return _tile_members(order, valid.sum(-1), n_points)
