"""Voxel CNN encoder (port of ``pointcloud_rl_tpu/models/voxel.py``).

Per-point stem MLP (in -> 32 -> 32, LN) -> voxelize at ``voxel_size`` (the
mean feature per voxel) -> three strided Conv3d(k=4, s=2) + LayerNorm +
ReLU -> max-pool over the occupied sites -> Dense + LayerNorm.

``impl="dense"`` scatter-means into a ``grid_size`` grid and convolves the
whole grid, empty voxels included (the dense semantics of the JAX package:
only the final pool looks at occupancy, carried through the stride chain by
a max-pool of the 0/1 grid).  ``impl="sparse"`` dedupes the occupied voxels
into ``sparse_capacity`` slots and runs the gather-based sparse conv of
``ops/sparse_conv.py``.

Layout: the grid stays channel-last ``[B, X, Y, Z, C]`` throughout, as flax
keeps it.  Each conv reads it through a ``[B, C, X, Y, Z]`` view, whose
strides are ``channels_last_3d``, and ``ops/conv.py`` writes its output in
that format (on a card its own kernels take and give that layout), so the
LayerNorm over C and the next conv need no permute copy.  Padding is flax's
``"SAME"``: ``ceil(n / s)`` outputs, the low side padded by half the total,
the high side by the rest (asymmetric on odd sizes, where it is padded
explicitly).  The convs run in f32.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import conv
from ..ops.masked import masked_max
from ..ops.sparse_conv import sparse_conv_layer
from ..ops.voxelize import voxelize_dense, voxelize_sparse
from . import NETWORK
from .blocks import MLP
from .init import torch_default_
from .pointnet import preprocess_pointcloud

_LN_EPS = 1e-6  # flax LayerNorm's default, after every conv and the final Dense


def same_padding(n: int, kernel: int, stride: int):
    """flax ``padding="SAME"`` along an axis of size n: (low, high)."""
    total = max((math.ceil(n / stride) - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


@NETWORK.register_module(name="SparseCNN")
@NETWORK.register_module()
class VoxelCNN(nn.Module):
    """Voxelized 3D conv encoder (config type ``SparseCNN`` too).

    ``in_channels`` per-point input features, ``mlp_spec`` the three conv
    widths, ``out_channels`` the final Dense (None: none); ``grid_size`` the
    dense grid (clouds are min-shifted into it)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: Optional[int] = None,
        voxel_size: float = 0.1,
        mlp_spec: Sequence[int] = (128, 256, 512),
        grid_size: Sequence[int] = (32, 32, 32),
        stem_channels: Sequence[int] = (32, 32),
        kernel_size: int = 4,
        stride: int = 2,
        norm_cfg: Optional[Any] = None,  # config parity; every conv is followed by LayerNorm
        act_cfg: Any = "ReLU",  # the stem's activation; the convs use ReLU
        impl: str = "dense",
        sparse_capacity: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if impl not in ("dense", "sparse"):
            raise ValueError(f"VoxelCNN impl={impl!r}: expected 'dense' or 'sparse'")
        self.impl = impl
        self.voxel_size = float(voxel_size)
        self.grid_size = tuple(int(g) for g in grid_size)
        self.kernel_size, self.stride = int(kernel_size), int(stride)
        self.sparse_capacity = sparse_capacity
        self.out_channels = out_channels
        self.MLP_0 = MLP([in_channels] + list(stem_channels), norm_cfg={"type": "LN", "eps": _LN_EPS},
                         act_cfg=act_cfg, inactivated_output=False, ignore_first_ln=True, generator=generator)
        k, k3 = self.kernel_size, self.kernel_size**3
        in_ch = list(stem_channels)[-1]
        self.widths = [int(c) for c in mlp_spec]
        for i, ch in enumerate(self.widths):
            if impl == "dense":
                layer = nn.Conv3d(in_ch, ch, k, self.stride)  # holds weight [C_out, C_in, k, k, k] and bias
                torch_default_(layer.weight, in_ch * k3, generator)
                torch_default_(layer.bias, in_ch * k3, generator)
                self.add_module(f"Conv_{i}", layer)
            else:
                w = nn.Parameter(torch.empty(k3, in_ch, ch))  # [taps, C_in, C_out], as the JAX param
                b = nn.Parameter(torch.empty(ch))
                torch_default_(w, in_ch * k3, generator)
                torch_default_(b, in_ch * k3, generator)
                self.register_parameter(f"sparse_conv{i}_kernel", w)
                self.register_parameter(f"sparse_conv{i}_bias", b)
            self.add_module(f"LayerNorm_{i}", nn.LayerNorm(ch, eps=_LN_EPS))
            in_ch = ch
        if out_channels is not None:
            self.Dense_0 = nn.Linear(in_ch, out_channels)
            torch_default_(self.Dense_0.weight, in_ch, generator)
            torch_default_(self.Dense_0.bias, in_ch, generator)
            self.add_module(f"LayerNorm_{len(self.widths)}", nn.LayerNorm(out_channels, eps=_LN_EPS))

    def forward(self, obs):
        feature = preprocess_pointcloud(obs)  # [B, N, C]
        xyz = feature[..., :3]
        x = self.MLP_0(feature)
        if self.impl == "sparse":
            pooled = self._sparse_forward(xyz, x)
        else:
            pooled = self._dense_forward(xyz, x)
        if self.out_channels is not None:
            pooled = getattr(self, f"LayerNorm_{len(self.widths)}")(self.Dense_0(pooled))
        return pooled

    def _dense_forward(self, xyz, x):
        k, s = self.kernel_size, self.stride
        grid, occ = voxelize_dense(xyz, x, self.voxel_size, self.grid_size)  # [B, X, Y, Z, C]
        occ = occ[:, None].to(grid.dtype)  # [B, 1, X, Y, Z]
        for i in range(len(self.widths)):
            pads = [same_padding(n, k, s) for n in grid.shape[1:4]]
            if all(lo == hi for lo, hi in pads):
                padding = [lo for lo, _ in pads]
            else:  # odd sizes: flax pads one more on the high side
                grid = F.pad(grid, (0, 0) + tuple(p for lo_hi in pads[::-1] for p in lo_hi))
                occ = F.pad(occ, tuple(p for lo_hi in pads[::-1] for p in lo_hi), value=-math.inf)
                padding = [0, 0, 0]
            layer = getattr(self, f"Conv_{i}")
            y = conv(grid.permute(0, 4, 1, 2, 3), layer.weight, layer.bias, (s,) * 3, padding)
            grid = torch.relu(getattr(self, f"LayerNorm_{i}")(y.permute(0, 2, 3, 4, 1)))
            occ = F.max_pool3d(occ, k, s, padding)
        B, C = grid.shape[0], grid.shape[-1]
        return masked_max(grid.reshape(B, -1, C), occ.reshape(B, -1, 1) > 0, dim=-2)

    def _sparse_forward(self, xyz, x):
        capacity = self.sparse_capacity or xyz.shape[-2]
        feat, coords, valid = voxelize_sparse(xyz, x, self.voxel_size, capacity)
        for i in range(len(self.widths)):
            feat, coords, valid = sparse_conv_layer(
                feat, coords, valid, getattr(self, f"sparse_conv{i}_kernel"), getattr(self, f"sparse_conv{i}_bias"),
                stride=self.stride, kernel_size=self.kernel_size)
            feat = torch.relu(getattr(self, f"LayerNorm_{i}")(feat) * valid[..., None])
        return masked_max(feat, valid[..., None], dim=-2)
