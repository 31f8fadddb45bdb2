"""Batched multi-camera depth -> fused world-frame point clouds.

Port of ``pointcloud_rl_tpu/ops/camera.py``: per-camera depth images are
unprojected with the camera intrinsics, moved into the world frame with the
camera-to-world matrices (one einsum over the batch) and concatenated
across cameras.  ``ops.sampling`` downsamples the result.  Plain tensor
functions: every input lies on one device, and the products run in the
process's matmul precision (f32 unless TF32 is switched on).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def depth_to_camera_xyz(depth: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Unproject ``depth [..., H, W]`` with pinhole ``intrinsics [..., 3, 3]``
    to camera-frame points ``[..., H*W, 3]`` at the pixel centres (u+0.5, v+0.5)."""
    H, W = depth.shape[-2:]
    v, u = torch.meshgrid(torch.arange(H, dtype=depth.dtype, device=depth.device),
                          torch.arange(W, dtype=depth.dtype, device=depth.device), indexing="ij")
    uv1 = torch.stack([u + 0.5, v + 0.5, torch.ones_like(u)], dim=-1)  # [H, W, 3]
    inv_k = torch.linalg.inv(intrinsics)
    rays = torch.einsum("...ij,hwj->...hwi", inv_k, uv1)
    xyz = rays * depth[..., None]
    return xyz.reshape(*depth.shape[:-2], H * W, 3)


def transform_points(xyz: torch.Tensor, cam2world: torch.Tensor) -> torch.Tensor:
    """Apply homogeneous ``[..., 4, 4]`` transforms to ``[..., N, 3]`` points."""
    rot = cam2world[..., :3, :3]
    trans = cam2world[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", rot, xyz) + trans[..., None, :]


def fuse_camera_pointclouds(depths: torch.Tensor, rgbs: torch.Tensor, intrinsics: torch.Tensor,
                            cam2world: torch.Tensor, segs: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Fuse per-camera renders into one world-frame cloud per env.

    Args:
      depths: ``[B, C, H, W]`` per-env per-camera depth.
      rgbs: ``[B, C, H, W, 3]`` colours (any dtype, passed through).
      intrinsics: ``[B, C, 3, 3]`` or ``[C, 3, 3]``.
      cam2world: ``[B, C, 4, 4]`` camera-to-world poses.
      segs: optional ``[B, C, H, W, K]`` masks.

    Returns:
      xyz ``[B, C*H*W, 3]`` world-frame, rgb ``[B, C*H*W, 3]``, seg or None.
    """
    B, C, H, W = depths.shape
    if intrinsics.dim() == 3:
        intrinsics = intrinsics.expand(B, C, 3, 3)
    world = transform_points(depth_to_camera_xyz(depths, intrinsics), cam2world)  # [B, C, H*W, 3]
    xyz = world.reshape(B, C * H * W, 3)
    rgb = rgbs.reshape(B, C * H * W, 3)
    seg = segs.reshape(B, C * H * W, -1) if segs is not None else None
    return xyz, rgb, seg
