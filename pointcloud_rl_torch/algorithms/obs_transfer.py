"""Observation transfer: the constant pos_encoding block and the act upload.

Port of ``pointcloud_rl_tpu/algorithms/obs_transfer.py``.  Two reductions,
both opt-in via ``agent_cfg.obs_transfer_cfg``:

1. ``pos_encoding_on_device``: the FrameStack wrapper's ``pos_encoding``
   block (a one-hot frame index, ``eye(F)`` repeated over each frame's
   points) is dropped from the act upload and from replay storage and
   re-synthesized on the device, with bitwise identical values.
2. ``pack_dtype``: the act upload is packed in a narrower dtype (e.g.
   float16) and cast back to float32 on the device, before the encoder.

``pack_mode`` ``"packed"`` uploads one host-assembled array of all the
channels (``base.pack_pointcloud_obs``); ``"dict"`` uploads the env's own
leaves (xyz, rgb uint8, seg, the robot state).  The update completes obs
dicts by key presence (``complete_obs_dict``) before any augmentation, so
the channel order xyz, rgb, pos_encoding, seg holds.

``pack_device_features`` is what a ``DeviceReplayMemory`` with
``transfer_cfg.pack_features`` stores: each observation as the model-input
tensor, once, at push time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class ObsTransferSpec:
    pos_rows: int  # F: pos_encoding channel count == stacked frame count
    insert_at: int  # channel offset of the block in the packed layout
    points_per_frame: int  # N // F (frame-major point ordering)
    drop_pos_encoding: bool = True
    pack_dtype: Optional[Any] = None  # numpy dtype of the act upload, e.g. np.float16
    pack_mode: str = "packed"  # "packed": one host-assembled array; "dict": the env's leaves
    # channel count of the reduced pack (all blocks but pos_encoding), which
    # tells a stripped pack from an already full one
    packed_channels: int = 0


def make_obs_transfer(cfg: Optional[dict], obs_shape) -> Optional[ObsTransferSpec]:
    """The spec of ``obs_transfer_cfg`` for the env's obs shapes; None when
    disabled, or when there is neither a block to drop nor a pack to make."""
    if not cfg:
        return None
    cfg = dict(cfg)
    drop = bool(cfg.pop("pos_encoding_on_device", True))
    pack_dtype = cfg.pop("pack_dtype", None)
    pack_mode = cfg.pop("pack_mode", "packed")
    if pack_mode not in ("packed", "dict"):
        raise ValueError(f"unknown pack_mode: {pack_mode}")
    if cfg:
        raise ValueError(f"unknown obs_transfer_cfg keys: {sorted(cfg)}")
    if pack_dtype is not None:
        pack_dtype = np.dtype(pack_dtype)
    if not (isinstance(obs_shape, dict) and "pos_encoding" in obs_shape):
        if pack_dtype is None and pack_mode == "packed":
            return None
        return ObsTransferSpec(0, 0, 0, drop_pos_encoding=False, pack_dtype=pack_dtype, pack_mode=pack_mode)
    rows, n = (int(s) for s in obs_shape["pos_encoding"])
    if n % rows:
        raise ValueError(f"pos_encoding {rows}x{n}: N not divisible by frames")
    insert_at = int(obs_shape["xyz"][0]) + (int(obs_shape["rgb"][0]) if "rgb" in obs_shape else 0)
    packed_channels = sum(int(obs_shape[k][0]) for k in ("xyz", "rgb", "seg") if k in obs_shape)
    return ObsTransferSpec(rows, insert_at, n // rows, drop_pos_encoding=drop, pack_dtype=pack_dtype,
                           pack_mode=pack_mode, packed_channels=packed_channels)


def synth_pos_encoding(rows: int, points_per_frame: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """[rows, rows*points_per_frame] one-hot block, equal to FrameStack's
    ``np.repeat(np.eye(F), num_points, axis=-1)``."""
    return torch.eye(rows, dtype=dtype, device=device).repeat_interleave(points_per_frame, dim=-1)


def pack_device_features(obs: Dict[str, Any], dtype=torch.bfloat16,
                         synth_pos: Optional[Tuple[int, int]] = None) -> Dict[str, torch.Tensor]:
    """Glue a point-cloud obs dict of tensors into the model-input tensor:
    ``{"pcd": [..., N, C] <dtype> (contiguous), "state"?: f32}``.

    Channel order is that of the PointNet's own preprocessing: xyz,
    rgb/255, pos_encoding, seg.  ``synth_pos=(rows, points_per_frame)``
    re-synthesizes a pos_encoding block that was stripped before upload."""
    feats = [obs["xyz"].float()]
    if "rgb" in obs:
        rgb = obs["rgb"]
        feats.append(rgb.float() / 255.0 if rgb.dtype == torch.uint8 else rgb.float())
    if "pos_encoding" not in obs and synth_pos is not None:
        rows, ppf = synth_pos
        pe = synth_pos_encoding(rows, ppf, device=feats[0].device)
        feats.append(pe.expand(feats[0].shape[:-2] + pe.shape))
    for key in ("pos_encoding", "seg"):
        if key in obs:
            feats.append(obs[key].float())
    out = {"pcd": torch.cat(feats, dim=-2).transpose(-1, -2).to(dtype).contiguous()}
    for key in ("state", "agent"):
        if key in obs:
            out[key] = obs[key].float()
    return out


def complete_packed(x: torch.Tensor, spec: ObsTransferSpec) -> torch.Tensor:
    """Cast a packed ``[..., C, N]`` act upload to float32 and insert the
    synthesized block.  Only the cast when the block was not dropped or the
    array already carries every channel."""
    x = x.float()
    if not spec.drop_pos_encoding:
        return x
    channels = x.shape[-2]
    if channels == spec.packed_channels + spec.pos_rows:
        return x
    if channels != spec.packed_channels:
        raise ValueError(f"packed obs carries {channels} channels; expected the reduced {spec.packed_channels} "
                         f"(stripped) or {spec.packed_channels + spec.pos_rows} (full)")
    pe = synth_pos_encoding(spec.pos_rows, spec.points_per_frame, device=x.device)
    pe = pe.expand(x.shape[:-2] + pe.shape)
    return torch.cat([x[..., :spec.insert_at, :], pe, x[..., spec.insert_at:, :]], dim=-2)


def complete_obs_dict(obs: Dict[str, Any], spec: ObsTransferSpec) -> Dict[str, Any]:
    """Re-attach ``pos_encoding`` (float32) to an obs dict whose copy was
    stripped of it; an obs that has it, or has no xyz, is returned as is."""
    if "pos_encoding" in obs or "xyz" not in obs:
        return obs
    leaf = obs["xyz"]
    pe = synth_pos_encoding(spec.pos_rows, spec.points_per_frame, device=leaf.device)
    obs = dict(obs)
    obs["pos_encoding"] = pe.expand(leaf.shape[:-2] + pe.shape)
    return obs
