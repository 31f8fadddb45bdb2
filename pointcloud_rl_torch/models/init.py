"""Weight initializers (port of ``pointcloud_rl_tpu/models/init.py:16-30``).

``torch_default`` is torch.nn.Linear's own default: uniform
+-1/sqrt(fan_in) for both weight and bias.  The port draws it from an
explicit ``torch.Generator`` so that a model built from a seed is the same
model on every run.  Weights are given in the layout of the tensor they
fill; ``fan_in`` is passed explicitly because the stacked critic keeps
its kernels as ``[heads, in, out]``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def uniform_(t: torch.Tensor, bound: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def torch_default_(t: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> torch.Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) in place (kernel and bias alike)."""
    return uniform_(t, 1.0 / math.sqrt(max(int(fan_in), 1)), generator)
