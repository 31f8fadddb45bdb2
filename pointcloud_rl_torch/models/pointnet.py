"""PointNet encoder (port of ``pointcloud_rl_tpu/models/pointnet.py``).

Per-point shared MLP over concat(xyz, rgb/255, pos_encoding, seg), a max
over the points, then ``final_dense`` + ``final_ln``.  Observations arrive
channel-first ``[B, C, N]`` (the env contract) and are moved to
channel-last ``[B, N, C]`` once, so every per-point layer is a Linear.

``fused=True`` runs the per-point body and the max-pool through the
hand-written CUDA kernel of ``ops/pointnet_fused.py`` when the layer
pattern is the one that kernel computes (``_fused_supported``).  Both
paths read ONE parameter set, the unfused ``conv`` MLP's, so a checkpoint
moves freely between ``fused=True`` and ``fused=False``.

``dtype="bfloat16"`` follows the JAX package: the per-point MLP (or the
fused body, as its compute dtype) and ``final_dense`` compute in bf16,
LayerNorms and the pooled feature in f32.  A packed bf16 ``{"pcd": ...}``
enters the fused body as it is.

``feature_transform`` adds the STNs of the JAX package (``STNkd``): ``[1]``
aligns xyz with a predicted 3 x 3 matrix, ``[2]`` splits the body into
``conv1`` -> a feature STN (``fstn``) -> ``conv2``.  Both run on the plain
path only; the fused kernel keeps its own conditions (``_fused_supported``).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
from torch import nn

from ..ops.pointnet_fused import fused_pointnet_body
from . import NETWORK
from .blocks import MLP, dense, resolve_dtype
from .init import torch_default_

_PN_LN_EPS = 1e-6  # the PointNet body's default norm (JAX pointnet.py:133)
_FINAL_LN_EPS = 1e-6  # flax's LayerNorm default, used by final_ln (JAX pointnet.py:158)


def preprocess_pointcloud(obs) -> torch.Tensor:
    """Assemble the per-point feature tensor, channel-LAST ``[B, N, C]``.

    Channel order is xyz, rgb/255 (uint8 rgb only), pos_encoding, seg.
    ``{"pcd": t}`` is an already assembled channel-last tensor and passes
    through untouched; a plain tensor is channel-first ``[B, C, N]``."""
    if not isinstance(obs, dict):
        return obs.float().transpose(-1, -2)
    if "pcd" in obs:
        return obs["pcd"]
    feats = [obs["xyz"].float()]
    if "rgb" in obs:
        rgb = obs["rgb"]
        feats.append(rgb.float() / 255.0 if rgb.dtype == torch.uint8 else rgb.float())
    for key in ("pos_encoding", "seg"):
        if key in obs:
            feats.append(obs[key].float())
    return torch.cat(feats, dim=-2).transpose(-1, -2)


class STNkd(nn.Module):
    """Spatial transformer predicting a k x k alignment matrix: an MLP over
    the points, a max-pool, an MLP head to k * k, plus the identity."""

    def __init__(self, k: int = 3, mlp_spec: Sequence[int] = (64, 128, 1024), norm_cfg: Optional[Any] = None,
                 act_cfg: Any = "ReLU", ignore_first_ln: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.k = k
        spec = [int(c) for c in mlp_spec]
        self.MLP_0 = MLP([k] + spec, norm_cfg=norm_cfg, act_cfg=act_cfg, inactivated_output=False,
                         ignore_first_ln=ignore_first_ln, generator=generator)
        head_spec = [spec[-1] // 2**i for i in range(len(spec))] + [k * k]
        self.MLP_1 = MLP(head_spec, norm_cfg=norm_cfg, act_cfg=act_cfg, inactivated_output=True,
                         generator=generator)

    def forward(self, points):  # [B, N, k]
        x = self.MLP_1(self.MLP_0(points).amax(dim=-2))
        x = x.reshape(x.shape[:-1] + (self.k, self.k))
        return torch.eye(self.k, dtype=x.dtype, device=x.device) + x


@NETWORK.register_module()
class PointNet(nn.Module):
    """Per-point MLP + symmetric max-pool encoder.

    feat_dim: per-point input channels (the ``pcd_all_channel``
    placeholder); out_channels: width of the final projection."""

    def __init__(
        self,
        feat_dim: int,
        mlp_spec: Sequence[int] = (64, 128, 1024),
        out_channels: Optional[int] = None,
        global_feat: bool = True,
        feature_transform: Sequence[int] = (1,),
        norm_cfg: Optional[Any] = None,
        act_cfg: Any = "ReLU",
        ignore_first_ln: bool = False,
        fused: bool = False,
        dtype: Optional[Any] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.compute_dtype = resolve_dtype(dtype)
        self.feature_transform = [int(t) for t in feature_transform]
        if not global_feat:
            raise NotImplementedError("Only global_feat=True is supported (parity with reference)")
        self.mlp_spec = [int(c) for c in mlp_spec]
        self.ignore_first_ln = ignore_first_ln
        self.act_cfg = act_cfg
        self.fused = fused
        norm = norm_cfg if norm_cfg is not None else {"type": "LN", "eps": _PN_LN_EPS}
        spec = self.mlp_spec
        stn_kw = dict(norm_cfg=norm, act_cfg=act_cfg, ignore_first_ln=ignore_first_ln, generator=generator)
        if 1 in self.feature_transform:
            self.stn = STNkd(3, spec, **stn_kw)
        if 2 in self.feature_transform:
            self.conv1 = MLP([feat_dim, spec[0]], norm_cfg=norm, act_cfg=act_cfg, inactivated_output=False,
                             ignore_first_ln=ignore_first_ln, generator=generator)
            self.fstn = STNkd(spec[0], spec, **stn_kw)
            self.conv2 = MLP(spec, norm_cfg=norm, act_cfg=act_cfg, inactivated_output=False, generator=generator)
        else:
            self.conv = MLP([feat_dim] + spec, norm_cfg=norm, act_cfg=act_cfg,
                            inactivated_output=False, ignore_first_ln=ignore_first_ln,
                            dtype=dtype, generator=generator)
        self.out_channels = out_channels
        if out_channels is not None:
            self.final_dense = nn.Linear(self.mlp_spec[-1], out_channels)
            torch_default_(self.final_dense.weight, self.mlp_spec[-1], generator)
            torch_default_(self.final_dense.bias, self.mlp_spec[-1], generator)
            self.final_ln = nn.LayerNorm(out_channels, eps=_FINAL_LN_EPS)

    def _fused_supported(self) -> bool:
        act = self.act_cfg
        return (
            self.fused
            and len(self.mlp_spec) == 3
            and not self.feature_transform
            and self.ignore_first_ln
            and (act in ("ReLU", {"type": "ReLU"}) or getattr(act, "get", lambda *_: None)("type") == "ReLU")
            # the kernel's LayerNorms use eps 1e-6
            and getattr(getattr(self.conv, "LayerNorm_0", None), "eps", None) == _PN_LN_EPS
        )

    def body_params(self):
        """The fused body's 10-tuple in the JAX layout (W as [in, out]).

        The transposed copies are differentiable, so gradients reach the
        Linear weights."""
        c = self.conv
        return (c.Dense_0.weight.t().contiguous(), c.Dense_0.bias,
                c.Dense_1.weight.t().contiguous(), c.Dense_1.bias,
                c.LayerNorm_0.weight, c.LayerNorm_0.bias,
                c.Dense_2.weight.t().contiguous(), c.Dense_2.bias,
                c.LayerNorm_1.weight, c.LayerNorm_1.bias)

    def forward(self, obs):
        feature = preprocess_pointcloud(obs)  # [B, N, C]
        if self._fused_supported():
            # the kernel reads x as contiguous [B, N, C] rows
            pooled = fused_pointnet_body(feature.contiguous(), self.body_params(), self.compute_dtype)
        else:
            if 1 in self.feature_transform:
                xyz = torch.einsum("...ni,...ij->...nj", feature[..., :3], self.stn(feature[..., :3]))
                feature = torch.cat([xyz, feature[..., 3:]], dim=-1)
            if 2 in self.feature_transform:
                feature = self.conv1(feature)
                feature = self.conv2(torch.einsum("...ni,...ij->...nj", feature, self.fstn(feature)))
            else:
                feature = self.conv(feature)
            pooled = feature.max(dim=-2).values
        if self.out_channels is not None:
            pooled = self.final_ln(dense(self.final_dense, pooled, self.compute_dtype).float())
        return pooled
