"""Seeded weights for the program's networks, made on the device.

The benchmark makes the weights itself and hands the same to the program
and to the reference: the program's parameters are overwritten in place
at set-up (``load_into``), and the reference makes them again from the
same seed after the window (``make``).  Only the names and shapes are
read from the program.  One uniform draw of every leaf at once, on the
device, from a ``torch.Generator`` seeded with the run's seed:

- a kernel and its bias: uniform in +-1/sqrt(fan in), torch's default;
  the encoder's leaves (``visual.``) take their fan in from the encoder's
  module (``encoders/<name>.py``: a convolution's counts its taps), the
  heads' from a dense kernel, ``[out, in]`` or a stacked ensemble's
  ``[heads, in, out]``;
- a LayerNorm's scale: 1 + uniform(-0.1, 0.1); its shift: uniform(-0.1, 0.1).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

from . import encoders


def _heads_fan_in(name: str, shapes: Dict[str, Tuple[int, ...]]) -> int:
    kernel = shapes[name[: -len("bias")] + "weight"] if name.endswith(".bias") else shapes[name]
    return int(kernel[1])  # [out, in] and [heads, in, out] alike


def make(shapes: Dict[str, Tuple[int, ...]], seed: int, device, encoder: str) -> Dict[str, torch.Tensor]:
    """Weights for the leaves ``shapes`` (name -> shape), from ``seed``; the
    configuration's encoder ``encoder`` seeds its own leaves."""
    enc = encoders.load(encoder)
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32) * 2.0 - 1.0
    out, start = {}, 0
    for name, size in zip(names, sizes):
        x = u[start:start + size].reshape(shapes[name])
        start += size
        own = name.startswith(encoders.PREFIX)
        if enc.is_norm(name) if own else "LayerNorm" in name:
            out[name] = 1.0 + 0.1 * x if name.endswith(".weight") else 0.1 * x
        else:
            out[name] = x / math.sqrt(enc.fan_in(name, shapes) if own else _heads_fan_in(name, shapes))
    return out


def shapes_of(named: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, Tuple[int, ...]]:
    return {n: tuple(p.shape) for n, p in named}


@torch.no_grad()
def load_into(agent, weights: Dict[str, torch.Tensor]) -> None:
    """Overwrite the agent's live networks and its target with ``weights``
    (the target's leaves are copies of the live critic's)."""
    for name, p in agent.model.named_parameters():
        p.copy_(weights[name])
    for name, p in agent.target.named_parameters():
        p.copy_(weights[name])
