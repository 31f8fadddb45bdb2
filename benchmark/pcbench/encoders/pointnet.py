"""PointNet: the reference encode, its FLOPs and how its leaves are seeded.

The port's ``PointNet`` with ``mlp_spec`` of three widths and
``out_channels``: three shared layers (ReLU; LayerNorm on the 2nd and
3rd), the max over points, a dense layer and a LayerNorm.  Its leaves:
``visual.conv.Dense_{0,1,2}``, ``visual.conv.LayerNorm_{0,1}``,
``visual.final_dense``, ``visual.final_ln``.  ``shapes`` keys read:
``points``, ``channels``, ``widths`` (the three), ``feature`` (the final
dense layer's width).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..reference import linear

_PN_EPS = 1e-6  # the PointNet body's and final LayerNorm's epsilon


def encode(P: Dict[str, torch.Tensor], pcd: torch.Tensor, precision: str) -> torch.Tensor:
    """PointNet over ``pcd [R, N, C]`` (channels xyz, rgb/255, then
    pos_encoding or seg): three shared layers (ReLU; LayerNorm on the 2nd
    and 3rd), the max over points, a dense layer and a LayerNorm."""
    R, N, C = pcd.shape
    x = pcd.reshape(R * N, C).float()
    p = "visual.conv."
    h = torch.relu(linear(x, P[p + "Dense_0.weight"], P[p + "Dense_0.bias"], precision))
    h = linear(h, P[p + "Dense_1.weight"], P[p + "Dense_1.bias"], precision)
    h = torch.relu(F.layer_norm(h, h.shape[-1:], P[p + "LayerNorm_0.weight"], P[p + "LayerNorm_0.bias"], _PN_EPS))
    h = linear(h, P[p + "Dense_2.weight"], P[p + "Dense_2.bias"], precision)
    h = torch.relu(F.layer_norm(h, h.shape[-1:], P[p + "LayerNorm_1.weight"], P[p + "LayerNorm_1.bias"], _PN_EPS))
    pooled = h.reshape(R, N, -1).max(dim=1).values
    f = linear(pooled, P["visual.final_dense.weight"], P["visual.final_dense.bias"], precision)
    return F.layer_norm(f, f.shape[-1:], P["visual.final_ln.weight"], P["visual.final_ln.bias"], _PN_EPS)


# ------------------------------------------------------------------ FLOPs
def body_flop(B: int, N: int, c_in: int, widths) -> int:
    """The three shared layers' products over ``B`` clouds of ``N`` points."""
    c1, c2, c3 = widths
    return 2 * B * N * (c_in * c1 + c1 * c2 + c2 * c3)


def _dims(shapes: Dict) -> Tuple[int, int, int, int, int, int]:
    c1, c2, c3 = (int(w) for w in shapes["widths"])
    return int(shapes["points"]), int(shapes["channels"]), c1, c2, c3, int(shapes["feature"])


def forward_flops(shapes: Dict, rows: int) -> int:
    """The body over every point and the final dense layer."""
    N, C, c1, c2, c3, F_ = _dims(shapes)
    return body_flop(rows, N, C, (c1, c2, c3)) + 2 * rows * c3 * F_


def backward_flops(shapes: Dict, rows: int) -> int:
    """The body's backward over one winner point per row and output channel
    (the max-pool sends each channel's gradient to one point), with no
    gradient of the input cloud, and the final dense layer's."""
    N, C, c1, c2, c3, F_ = _dims(shapes)
    body_bwd = rows * c3 * (2 * 2 * c2 * c3 + 2 * 2 * c1 * c2 + 2 * C * c1)
    return body_bwd + 2 * 2 * rows * c3 * F_


# ------------------------------------------------------------------ seeding
def is_norm(name: str) -> bool:
    return "LayerNorm" in name or name.endswith(("final_ln.weight", "final_ln.bias"))


def fan_in(name: str, shapes: Dict[str, Tuple[int, ...]]) -> int:
    """A dense kernel ``[out, in]`` and its bias: ``in``."""
    kernel = shapes[name[: -len("bias")] + "weight"] if name.endswith(".bias") else shapes[name]
    return int(kernel[1])
