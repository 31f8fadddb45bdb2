"""Gather-based sparse 3D convolution with static shapes (port of
``pointcloud_rl_tpu/ops/sparse_conv.py``).

Works on the occupied-voxel table of ``ops/voxelize.voxelize_sparse``.  Per
layer:

1. output sites = the stable sort-dedupe of ``in_coords // stride`` into the
   same capacity;
2. for each of the kernel's ``K^3`` taps, the input voxel at
   ``out * stride + offset`` is found by a left-side ``searchsorted`` over the
   sorted int32 input keys (a miss reads an appended zero row);
3. the taps are accumulated one at a time into a ``[B, M, C_out]`` f32
   accumulator, so no ``[B, M, K^3, C_in]`` gather is ever materialised.

Each tap multiplies the sorted input table by its weight and gathers the
product's rows, which is the gather-then-multiply of the JAX package row
for row; autograd then keeps the one table and an index per tap, not a
gathered copy per tap.  These are PyTorch ops, not a hand kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .voxelize import INT32_MAX, _scatter_slots, _segment_ranks


def _coord_key(coords: torch.Tensor) -> torch.Tensor:
    """[..., 3] int coords -> int32 key (grid coords < 2^10 per axis; offsets
    can reach -1, hence the +1)."""
    c = coords.to(torch.int32) + 1
    return (c[..., 0] << 20) | (c[..., 1] << 10) | c[..., 2]


def downsample_sites(coords: torch.Tensor, valid: torch.Tensor, stride: int,
                     capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unique ``coords // stride`` over valid sites -> (out_coords [B, M, 3]
    int32, out_valid [B, M]), in key order."""
    down = torch.div(coords, stride, rounding_mode="floor")
    key = torch.where(valid, _coord_key(down), INT32_MAX)
    order = torch.argsort(key, dim=-1, stable=True)
    ks = torch.gather(key, 1, order)
    cs = torch.gather(down, 1, order[..., None].expand(-1, -1, 3))
    rank, n = _segment_ranks(ks, capacity)
    out = _scatter_slots(rank, cs, capacity, "amax")[:, :capacity]
    out_valid = torch.arange(capacity, device=coords.device) < n.clamp_max(capacity)[:, None]
    return out * out_valid[..., None], out_valid


def tap_offsets(kernel_size: int, device=None) -> torch.Tensor:
    """The ``K^3`` offsets [K^3, 3], x slowest, spanning ``-(K//2-1) .. K//2``."""
    lo = -(kernel_size // 2 - 1)
    r = torch.arange(lo, lo + kernel_size, dtype=torch.int32, device=device)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(-1, 3)


def sparse_conv_layer(feat: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor, weights: torch.Tensor,
                      bias: torch.Tensor, stride: int = 2, kernel_size: int = 4):
    """One strided sparse conv: (feat [B, M, C_in], coords, valid) -> the
    downsampled (feat [B, M, C_out], coords, valid) of the same capacity.

    weights: [K^3, C_in, C_out], tap t at ``tap_offsets(K)[t]``."""
    B, M, c_in = feat.shape
    assert weights.shape[0] == kernel_size**3
    out_coords, out_valid = downsample_sites(coords, valid, stride, M)

    in_key = torch.where(valid, _coord_key(coords), INT32_MAX)
    order = torch.argsort(in_key, dim=1, stable=True)
    sorted_key = torch.gather(in_key, 1, order).contiguous()
    sorted_feat = torch.gather(feat, 1, order[..., None].expand(-1, -1, c_in))
    sorted_feat = torch.cat([sorted_feat, sorted_feat.new_zeros((B, 1, c_in))], dim=1)  # the miss row

    base = out_coords * stride
    c_out = weights.shape[-1]
    acc = torch.zeros((B, M, c_out), dtype=torch.float32, device=feat.device)
    for off, w in zip(tap_offsets(kernel_size, feat.device), weights):
        q_key = _coord_key(base + off).contiguous()
        pos = torch.searchsorted(sorted_key, q_key).clamp(0, M - 1)
        hit = torch.gather(sorted_key, 1, pos) == q_key
        idx = torch.where(hit, pos, M)
        prod = torch.matmul(sorted_feat, w).float()  # [B, M + 1, C_out]
        acc = acc + torch.gather(prod, 1, idx[..., None].expand(-1, -1, c_out))
    return (acc + bias) * out_valid[..., None], out_coords, out_valid
