"""The observation stage of a walker loop cell against a plain reference.

The stand-in's envs ship raw renders (depth, rgb, the camera row); the
program fuses them into point clouds on the card and packs them into its
replay.  The loop cell keeps the raw renders and the clouds of every
fusion call of a few window cycles, and after the window:

- ``fuse_faults``: frames whose points are not the reference's.  The
  reference unprojects every pixel in float64 (rays through the pixel
  centres of the stand-in's camera, times depth, rotated by the camera
  row, lifted by its height) and splits ground from body at the lowest
  valid height plus ``ground_eps``.  Each fused point has to lie at one
  pixel of its side (``n_points - num_ground`` body points, then
  ``num_ground`` ground points), with that pixel's colour; a side with at
  least as many pixels as points gives distinct pixels, an empty side
  zeros; and each frame carries its one-hot.  Which pixels are drawn is
  the program's random choice and is not compared.
- ``store_faults``: fused observations that no row of the replay holds,
  bit for bit, as the configuration packs them (xyz, rgb/255, the frame
  one-hot, in the storage's dtype).

Imports nothing of the port.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

XYZ_ABS, XYZ_REL = 1e-4, 1e-5  # float32 unprojection against float64: about 1e-6 at the scene's 40 m
SPLIT_BAND = 1e-4  # heights this close to the split may fall on either side in float32
FAR = 1e30


def inverse_intrinsic(image_size, fovy: float) -> np.ndarray:
    """The inverse pinhole intrinsics of a ``fovy``-degree camera of ``image_size`` (w, h)."""
    w, h = (float(v) for v in image_size)
    focal = 0.5 * h / math.tan(fovy * math.pi / 360.0)
    k = np.array([[focal, 0.0, (w - 1) / 2.0], [0.0, focal, (h - 1) / 2.0], [0.0, 0.0, 1.0]])
    return np.linalg.inv(k)


def unproject(depth: torch.Tensor, cam: torch.Tensor, inv_k: np.ndarray, z_to_world: bool) -> torch.Tensor:
    """``[F, H*W, 3]`` float64 points of ``depth [F, H, W]`` seen by the
    camera rows ``cam [F, 12]`` (rotation, then its height)."""
    F, H, W = depth.shape
    v, u = np.indices((H, W))
    uv1 = np.stack([u + 0.5, v + 0.5, np.ones((H, W))], -1).reshape(-1, 3)
    rays = torch.as_tensor(uv1 @ inv_k.T, dtype=torch.float64, device=depth.device)
    p = rays[None] * depth.double().reshape(F, H * W, 1)
    rot = cam[:, :9].double().reshape(F, 3, 3)
    xyz = torch.einsum("fnj,fij->fni", p, rot)
    if z_to_world:
        xyz[..., 2] += cam[:, 9, None].double()
    return xyz


def _side_ok(got, gcol, slots, ref, col, member, amb, valid) -> bool:
    """Whether the fused points ``got [n, 3]`` (colours ``gcol``) of one side
    are that side's pixels of the frame (``member`` strictly, ``amb`` either
    side)."""
    strict = int((member & ~amb).sum())
    loose = int((member | (amb & valid)).sum())
    zeros = bool((got == 0).all() and (gcol == 0).all())
    if loose == 0 or (strict == 0 and zeros):  # an empty side is zeroed (it may be empty in float32)
        return zeros
    allowed = member | (amb & valid)
    cand = torch.where(allowed[:, None], ref, torch.full_like(ref, FAR))
    dist = torch.cdist(got[None], cand[None], compute_mode="donot_use_mm_for_euclid_dist")[0]
    nd, nn = dist.min(-1)
    ok = (nd <= XYZ_ABS + XYZ_REL * got.norm(dim=-1)).all()
    ok &= (gcol == col[nn]).all()
    if strict >= slots:  # enough pixels: drawn without repeats
        ok &= nn.unique().numel() == slots
    return bool(ok)


def fuse_faults(captures: List[Tuple[dict, dict]], env: dict, z_to_world: bool, device) -> int:
    """Frames of the captured fusion calls (``(raw, fused)`` pairs) whose
    points are not the reference's; see the module's docstring."""
    inv_k = inverse_intrinsic(env["image_size"], float(env["fovy"]))
    P, NG = int(env["n_points"]), int(env["num_ground"])
    eps, max_depth = float(env["ground_eps"]), float(env["max_depth"])
    bad = 0
    for raw, fused in captures:
        depth = torch.as_tensor(np.asarray(raw["depth"]), device=device)
        B, S, H, W = depth.shape
        col = torch.as_tensor(np.asarray(raw["rgb"]), device=device).reshape(B, S, 3, H * W).transpose(-1, -2)
        ref = unproject(depth.reshape(B * S, H, W), torch.as_tensor(np.asarray(raw["cam"]), device=device)
                        .reshape(B * S, 12), inv_k, z_to_world).reshape(B, S, H * W, 3)
        valid = (depth <= max_depth).reshape(B, S, H * W)
        z = ref[..., 2]
        split = torch.where(valid, z, torch.full_like(z, FAR)).amin(-1, keepdim=True) + eps
        ground = valid & (z <= split)
        amb = valid & ((z - split).abs() <= SPLIT_BAND)
        got = torch.as_tensor(np.asarray(fused["xyz"]), device=device).double().reshape(B, 3, S, P).permute(0, 2, 3, 1)
        gcol = torch.as_tensor(np.asarray(fused["rgb"]), device=device).reshape(B, 3, S, P).permute(0, 2, 3, 1)
        pos = torch.as_tensor(np.asarray(fused["pos_encoding"]), device=device)
        onehot = torch.eye(S, dtype=pos.dtype, device=device).repeat_interleave(P, -1)
        for b in range(B):
            for s in range(S):
                ok = bool((pos[b, s] == onehot[s]).all())
                for member, lo, hi in ((valid[b, s] & ~ground[b, s], 0, P - NG), (ground[b, s], P - NG, P)):
                    ok = ok and _side_ok(got[b, s, lo:hi], gcol[b, s, lo:hi], hi - lo, ref[b, s], col[b, s],
                                         member, amb[b, s], valid[b, s])
                bad += int(not ok)
    return bad


def packed(fused: dict, dtype, device) -> torch.Tensor:
    """``[B, N, C]``: a fused batch as a packed replay stores it."""
    xyz = torch.as_tensor(np.asarray(fused["xyz"]), device=device).float()
    rgb = torch.as_tensor(np.asarray(fused["rgb"]), device=device).float() / 255.0
    pos = torch.as_tensor(np.asarray(fused["pos_encoding"]), device=device).float()
    return torch.cat([xyz, rgb, pos], dim=1).transpose(1, 2).to(dtype).contiguous()


def store_faults(captures: List[Tuple[dict, dict]], stored: Dict[str, torch.Tensor]) -> int:
    """Fused observations of ``captures`` that no row of ``stored`` (the
    replay's filled ``obs`` and ``next_obs`` pcd, ``[R, N, C]``) holds bit for
    bit."""
    missing = 0
    for _, fused in captures:
        some = next(iter(stored.values()))
        want = packed(fused, some.dtype, some.device)  # [B, N, C]
        found = torch.zeros(want.shape[0], dtype=torch.bool, device=want.device)
        for rows in stored.values():
            flat, wflat = rows.reshape(rows.shape[0], -1), want.reshape(want.shape[0], -1)
            k = min(64, flat.shape[1])
            cand = (wflat[:, None, :k] == flat[None, :, :k]).all(-1)  # [B, R]: the first values agree
            for i, j in cand.nonzero().tolist():
                if not found[i] and torch.equal(wflat[i], flat[j]):
                    found[i] = True
        missing += int((~found).sum())
    return missing
