"""Masked reductions (port of ``pointcloud_rl_tpu/ops/masked.py``)."""

from __future__ import annotations

import torch


def masked_max(x: torch.Tensor, mask: torch.Tensor, dim: int = -2, empty_value: float = 0.0) -> torch.Tensor:
    """Max over ``dim`` counting only positions where ``mask`` is true;
    ``empty_value`` where no position is.  ``mask`` broadcasts against x
    with a trailing feature axis of 1."""
    mask = mask.bool()
    filled = torch.where(mask, x, torch.finfo(x.dtype).min)
    out = filled.amax(dim=dim)
    return torch.where(mask.any(dim=dim), out, torch.full((), empty_value, dtype=x.dtype, device=x.device))


def masked_average(x: torch.Tensor, mask: torch.Tensor, dim: int = -2, eps: float = 1e-8) -> torch.Tensor:
    mask = mask.to(x.dtype)
    return (x * mask).sum(dim=dim) / mask.sum(dim=dim).clamp_min(eps)
