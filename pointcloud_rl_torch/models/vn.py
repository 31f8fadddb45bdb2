"""Vector-Neurons PointNet, an SO(3)-equivariant point encoder (port of
``pointcloud_rl_tpu/models/vn.py``).

A k-NN edge lift, VN linear / LayerNorm / LeakyReLU blocks over the
``mlp_spec`` vector-channel widths, an invariant readout against a learned
equivariant frame, a Dense, a max-pool over the points and a LayerNorm.
Vector features are channel-last ``[..., C, 3]``; each VNLinear is a Linear
over C on the ``[..., 3, C]`` transpose, so its batch dims fold into one
product.  Norms are written as ``sqrt(sum(x * x))``, as
``jnp.linalg.norm`` computes them (and differentiates them).

The k-NN picks are deterministic: on an exact tie of distances the lower
index wins, as ``lax.top_k`` breaks ties.  ``knn_indices`` ranks an int64
key of (the distance's order-preserving int32 bits, the index), so ties
cannot reorder whatever the top-k implementation.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from . import NETWORK
from .init import torch_default_
from .pointnet import preprocess_pointcloud

_LN_EPS = 1e-6  # flax LayerNorm's default (the output norm)


def _linear(in_features: int, out_features: int, bias: bool, generator) -> nn.Linear:
    layer = nn.Linear(in_features, out_features, bias=bias)
    torch_default_(layer.weight, in_features, generator)
    if bias:
        torch_default_(layer.bias, in_features, generator)
    return layer


class VNLinear(nn.Module):
    """Channel-mixing linear map ``[.., C_in, 3] -> [.., C_out, 3]``, no bias
    (a constant vector would break equivariance)."""

    def __init__(self, in_channels: int, out_channels: int, generator=None):
        super().__init__()
        self.Dense_0 = _linear(in_channels, out_channels, False, generator)

    def forward(self, x):
        return F.linear(x.transpose(-1, -2), self.Dense_0.weight).transpose(-1, -2)


class VNLeakyReLU(nn.Module):
    """Vector-Neurons LeakyReLU: a learned per-channel direction d splits each
    vector's half-space; the negative side is projected onto the plane
    orthogonal to d, blended by the leaky slope."""

    def __init__(self, channels: int, negative_slope: float = 0.2, generator=None):
        super().__init__()
        self.negative_slope = negative_slope
        self.VNLinear_0 = VNLinear(channels, channels, generator)

    def forward(self, q):
        d = self.VNLinear_0(q)
        dot = (q * d).sum(dim=-1, keepdim=True)
        d_sq = (d * d).sum(dim=-1, keepdim=True)
        q_proj = q - (dot / (d_sq + 1e-8)) * d
        alpha = self.negative_slope
        return alpha * q + (1.0 - alpha) * torch.where(dot >= 0.0, q, q_proj)


class VNLayerNorm(nn.Module):
    """RMS-normalise the vector norms across channels with a learnable
    per-channel ``gain``: a strictly positive scale, so directions stay."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.gain = nn.Parameter(torch.ones(channels))

    def forward(self, x):  # [.., C, 3]
        norms = torch.sqrt((x * x).sum(dim=-1))  # [.., C]
        rms = torch.sqrt((norms * norms).mean(dim=-1, keepdim=True) + self.eps)
        return x * (self.gain / (rms + self.eps))[..., None]


class VNBlock(nn.Module):
    """VNLinear -> VNLayerNorm -> VNLeakyReLU."""

    def __init__(self, in_channels: int, out_channels: int, use_norm: bool = True, generator=None):
        super().__init__()
        self.VNLinear_0 = VNLinear(in_channels, out_channels, generator)
        self.VNLayerNorm_0 = VNLayerNorm(out_channels) if use_norm else None
        self.VNLeakyReLU_0 = VNLeakyReLU(out_channels, generator=generator)

    def forward(self, x):
        x = self.VNLinear_0(x)
        if self.VNLayerNorm_0 is not None:
            x = self.VNLayerNorm_0(x)
        return self.VNLeakyReLU_0(x)


def knn_indices(xyz: torch.Tensor, k: int) -> torch.Tensor:
    """k nearest neighbours (self excluded) from the dense squared-distance
    matrix, as the JAX package computes it: [B, N, 3] -> [B, N, k] int64,
    nearest first, ties to the lower index."""
    sq = (xyz * xyz).sum(dim=-1)
    d2 = sq[..., :, None] + sq[..., None, :] - 2.0 * torch.einsum("bnd,bmd->bnm", xyz, xyz)
    n = xyz.shape[-2]
    d2 = d2 + torch.eye(n, dtype=d2.dtype, device=d2.device) * 1e9 + 0.0  # + 0.0: no -0.0
    bits = d2.contiguous().view(torch.int32)
    order = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()  # ascending with d2
    key = (order << 32) | torch.arange(n, device=xyz.device)
    return torch.topk(key, k, dim=-1, largest=False, sorted=True).values & 0xFFFFFFFF


@NETWORK.register_module()
class VNPointNet(nn.Module):
    """SO(3)-equivariant point encoder with an invariant global readout.

    feat_dim: per-point input channels; the first 3 are xyz (lifted to
    vector features), the rest are scalar channels that join at the
    invariant readout."""

    def __init__(
        self,
        feat_dim: int,
        mlp_spec: Sequence[int] = (128, 128, 256),
        out_channels: int = 128,
        n_knn: int = 4,
        norm_cfg: Optional[Any] = None,  # config parity; VNLayerNorm is the only VN-safe norm here
        act_cfg: Any = "LeakyReLU",  # config parity; VNLeakyReLU is the VN activation
        dtype: Optional[Any] = None,  # config parity; VN math stays f32
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.n_knn = int(n_knn)
        spec = [int(c) for c in mlp_spec]
        in_ch = 2
        for i, width in enumerate(spec):
            self.add_module(f"VNBlock_{i}", VNBlock(in_ch, width, generator=generator))
            in_ch = width
        self.n_blocks = len(spec)
        self.add_module(f"VNBlock_{self.n_blocks}", VNBlock(in_ch, 3, use_norm=False, generator=generator))
        readout = 3 * in_ch + feat_dim - 3
        self.Dense_0 = _linear(readout, out_channels, True, generator)
        self.LayerNorm_0 = nn.LayerNorm(out_channels, eps=_LN_EPS)

    def forward(self, obs):
        feature = preprocess_pointcloud(obs).float()  # [B, N, C]
        xyz, extras = feature[..., :3], feature[..., 3:]
        xyz_c = xyz - xyz.mean(dim=-2, keepdim=True)

        idx = knn_indices(xyz_c, self.n_knn)  # [B, N, K]
        B, N, K = idx.shape
        neigh = torch.gather(xyz_c, 1, idx.reshape(B, N * K, 1).expand(-1, -1, 3)).reshape(B, N, K, 3)
        edges = neigh - xyz_c[..., None, :]
        point = xyz_c[..., None, :].expand_as(edges)
        v = torch.stack([edges, point], dim=-2)  # [B, N, K, 2, 3]

        v = self.VNBlock_0(v).mean(dim=2)  # pool the neighbourhood -> [B, N, C0, 3]
        for i in range(1, self.n_blocks):
            v = getattr(self, f"VNBlock_{i}")(v)
        frame = getattr(self, f"VNBlock_{self.n_blocks}")(v)  # [B, N, 3, 3]
        inv = torch.einsum("bncd,bnkd->bnck", v, frame)  # [B, N, C_last, 3]
        inv = inv.reshape(B, N, -1)
        if extras.shape[-1] > 0:
            inv = torch.cat([inv, extras], dim=-1)
        x = self.Dense_0(inv).amax(dim=-2)
        return self.LayerNorm_0(x)
