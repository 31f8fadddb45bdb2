"""The port's side of the encoder in the test of the encoder plug.

``TapNet``: per point, a sum of taps, each the product of the point ``t``
places on (``roll`` over the points) with the tap's kernel ``[taps, in,
width]``, plus a bias, a LayerNorm and a ReLU; the max over the points; a
dense layer and a LayerNorm.  It is no model of the paper: a module that no
file of the benchmark knows, with a kernel whose shape tells its taps from
a stacked critic's heads only by its name.  ``register()`` puts it in the
port's ``NETWORK`` registry, as a model the port gained would be.
"""

import torch
from torch import nn

from pointcloud_rl_torch.models import NETWORK
from pointcloud_rl_torch.models.pointnet import preprocess_pointcloud


class TapNet(nn.Module):
    def __init__(self, feat_dim: int, width: int, out_channels: int, taps: int = 3, generator=None):
        super().__init__()
        self.taps = int(taps)
        self.tap_kernel = nn.Parameter(torch.zeros(self.taps, feat_dim, width))
        self.tap_bias = nn.Parameter(torch.zeros(width))
        self.LayerNorm_0 = nn.LayerNorm(width, eps=1e-6)
        self.Dense_0 = nn.Linear(width, out_channels)
        self.LayerNorm_1 = nn.LayerNorm(out_channels, eps=1e-6)

    def forward(self, obs):
        x = preprocess_pointcloud(obs)  # [B, N, C]
        h = self.tap_bias + sum(torch.roll(x, -t, dims=1) @ self.tap_kernel[t] for t in range(self.taps))
        h = torch.relu(self.LayerNorm_0(h))
        return self.LayerNorm_1(self.Dense_0(h.max(dim=1).values))


def register() -> None:
    if "TapNet" not in NETWORK:
        NETWORK.register_module()(TapNet)
