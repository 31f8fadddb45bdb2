"""Batched raw-render -> point-cloud observation fusion on the device.

Port of ``pointcloud_rl_tpu/ops/obs_fuse.py``.  Env workers that run DM
Control in ``obs_mode="raw"`` ship the render products (depth image, rgb
image, camera pose); one call here unprojects, ground/body-splits and
downsamples every env's stacked frames at once, and returns the
FrameStack point-cloud contract.  The numbers follow the host pipeline
(``env/dmc.py:get_obs``): camera-centred world-oriented unprojection, an
optional z-to-world lift, the ground split at ``min(valid z) + ground_eps``
(or a fixed base z), ``num_ground`` ground points after ``n_points -
num_ground`` body points, pad-by-tiling, and zeros for an empty side.

The unprojection is written as separately rounded f32 multiplies and adds
in a fixed order, not as a matmul, so the card and the CPU compute the
same bits: the ground split compares heights with a threshold, and a
product summed in another order (or in TF32) would move points across it.

Randomness: the per-side orders come from uniforms, drawn from a
``torch.Generator`` on the data's device or passed in as ``draws``
(``(body, ground)``, each ``[B, S, H*W]`` in [0, 1)).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

_BIG = 1e9


def unproject_rays(h: int, w: int, inv_k: torch.Tensor) -> torch.Tensor:
    """``[H, W, 3]`` rays ``(u + 0.5, v + 0.5, 1) @ inv_k.T`` in f32, summed in index order."""
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=inv_k.device),
                          torch.arange(w, dtype=torch.float32, device=inv_k.device), indexing="ij")
    u, v = u + 0.5, v + 0.5
    k = inv_k.float()
    return torch.stack([u * k[i, 0] + v * k[i, 1] + k[i, 2] for i in range(3)], dim=-1)


def _rotate(p: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """``p @ rot.T`` for ``p [..., HW, 3]`` and ``rot [..., 3, 3]``, summed in index order."""
    r = rot[..., None, :, :]
    return torch.stack([p[..., 0] * r[..., j, 0] + p[..., 1] * r[..., j, 1] + p[..., 2] * r[..., j, 2]
                        for j in range(3)], dim=-1)


def _pick(r: torch.Tensor, mask: torch.Tensor, count: int) -> torch.Tensor:
    """``count`` indices per row: the members of ``mask`` in the random order
    of ``r`` (non-members last), tiled over the members."""
    order = torch.argsort(torch.where(mask, r, _BIG + r), dim=-1, stable=True)
    n = mask.sum(-1, keepdim=True).clamp_min(1)
    pos = torch.arange(count, device=r.device)
    return order.gather(-1, pos % n)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx [B, S, P]`` of ``x [B, S, HW, 3]``."""
    return x.gather(2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def dmc_raw_to_pointcloud(depth: torch.Tensor, rgb: torch.Tensor, cam: torch.Tensor, inv_k: torch.Tensor, *,
                          n_points: int, num_ground: int, ground_eps: float, max_depth: float, z_to_world: bool,
                          fix_base_z: Optional[float] = None, generator: Optional[torch.Generator] = None,
                          draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """Fuse raw DMC render products into the point-cloud obs contract.

    Args (tensors on one device):
      depth: ``[B, S, H, W]`` f32 true depth (S stacked frames, oldest first).
      rgb:   ``[B, 3*S, H, W]`` u8 (the FrameStack channel-concat of image modes).
      cam:   ``[B, S, 1, 12]`` f32: the camera rotation's 9 entries, then [cam_z, 0, 0].
      inv_k: ``[3, 3]`` inverse camera intrinsics.
      generator / draws: the source of the per-side uniforms (one of the two).
    Returns:
      ``{"xyz": [B, 3, S*P] f32, "rgb": [B, 3, S*P] u8, "pos_encoding": [B, S, S*P] u8}``.
    """
    B, S, H, W = depth.shape
    if draws is None:
        draws = tuple(torch.rand((B, S, H * W), generator=generator, device=depth.device) for _ in range(2))
    r_body, r_ground = draws
    d = depth.float()
    col = rgb.reshape(B, S, 3, H * W).transpose(-1, -2)  # [B, S, HW, 3]
    cm = cam.reshape(B, S, 12).float()
    rays = unproject_rays(H, W, inv_k).reshape(H * W, 3)
    xyz = _rotate(rays * d.reshape(B, S, H * W, 1), cm[..., :9].reshape(B, S, 3, 3))  # [B, S, HW, 3]
    if z_to_world:
        xyz = torch.cat([xyz[..., :2], xyz[..., 2:] + cm[..., 9, None, None]], dim=-1)
    z = xyz[..., 2]
    valid = (d <= max_depth).reshape(B, S, H * W)
    if fix_base_z is None:
        base_z = torch.where(valid, z, torch.full_like(z, _BIG)).amin(-1, keepdim=True)
    else:
        base_z = torch.full_like(z[..., :1], fix_base_z)
    ground = valid & (z <= base_z + ground_eps)
    body = valid & ~ground

    parts_xyz, parts_col = [], []
    for r, mask, count in ((r_body, body, n_points - num_ground), (r_ground, ground, num_ground)):
        idx = _pick(r, mask, count)
        has = mask.any(-1)[..., None, None]  # an empty side is zeroed
        parts_xyz.append(torch.where(has, _take(xyz, idx), 0.0))
        parts_col.append(torch.where(has, _take(col, idx), 0).to(torch.uint8))
    P = n_points
    out_xyz = torch.cat(parts_xyz, dim=2).reshape(B, S * P, 3).transpose(1, 2).contiguous()
    out_rgb = torch.cat(parts_col, dim=2).reshape(B, S * P, 3).transpose(1, 2).contiguous()
    pos = torch.eye(S, dtype=torch.uint8, device=depth.device).repeat_interleave(P, dim=-1)
    return {"xyz": out_xyz, "rgb": out_rgb, "pos_encoding": pos.expand(B, S, S * P).contiguous()}
