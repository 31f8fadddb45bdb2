"""TapNet (the test of the encoder plug): the reference encode, its FLOPs,
how its leaves are seeded.  ``shapes`` keys read: ``points``, ``channels``,
``taps``, ``width``, ``feature``."""

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..reference import linear, matmul

_EPS = 1e-6


def encode(P: Dict[str, torch.Tensor], pcd: torch.Tensor, precision: str) -> torch.Tensor:
    x = pcd.float()
    kernel = P["visual.tap_kernel"]
    h = P["visual.tap_bias"] + sum(matmul(torch.roll(x, -t, dims=1), kernel[t], precision)
                                   for t in range(kernel.shape[0]))
    h = torch.relu(F.layer_norm(h, h.shape[-1:], P["visual.LayerNorm_0.weight"], P["visual.LayerNorm_0.bias"], _EPS))
    f = linear(h.max(dim=1).values, P["visual.Dense_0.weight"], P["visual.Dense_0.bias"], precision)
    return F.layer_norm(f, f.shape[-1:], P["visual.LayerNorm_1.weight"], P["visual.LayerNorm_1.bias"], _EPS)


def _dims(shapes: Dict) -> Tuple[int, int, int, int, int]:
    return (int(shapes["points"]), int(shapes["channels"]), int(shapes["taps"]), int(shapes["width"]),
            int(shapes["feature"]))


def forward_flops(shapes: Dict, rows: int) -> int:
    N, C, T, W, F_ = _dims(shapes)
    return 2 * rows * N * T * C * W + 2 * rows * W * F_


def backward_flops(shapes: Dict, rows: int) -> int:
    """The kernel's gradient over every point (no input gradient), the dense layer's two."""
    N, C, T, W, F_ = _dims(shapes)
    return 2 * rows * N * T * C * W + 2 * 2 * rows * W * F_


def is_norm(name: str) -> bool:
    return "LayerNorm" in name


def fan_in(name: str, shapes: Dict[str, Tuple[int, ...]]) -> int:
    """The taps' kernel ``[taps, in, width]`` and its bias: taps x in; the dense layer: its in."""
    if name.startswith("visual.tap_"):
        taps, c_in, _ = shapes["visual.tap_kernel"]
        return int(taps * c_in)
    kernel = shapes[name[: -len("bias")] + "weight"] if name.endswith(".bias") else shapes[name]
    return int(kernel[1])
