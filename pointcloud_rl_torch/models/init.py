"""Weight initializers (port of ``pointcloud_rl_tpu/models/init.py``).

``torch_default`` is torch.nn.Linear's own default: uniform
+-1/sqrt(fan_in) for both weight and bias.  The port draws it from an
explicit ``torch.Generator`` so that a model built from a seed is the same
model on every run.  Weights are given in the layout of the tensor they
fill; ``fan_in`` is passed explicitly because the stacked critic keeps
its kernels as ``[heads, in, out]``.  ``orthogonal_init``,
``delta_orthogonal_init`` and ``build_init`` (a config's ``conv_init_cfg``)
draw from the same generator; their values differ from the JAX package's
draws, their structure does not.
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


def _orthogonal(n_rows: int, n_cols: int, gain: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """An [n_rows, n_cols] matrix with orthonormal columns (n_rows >= n_cols)
    or rows, times ``gain``: the QR of a normal draw with the signs of R's
    diagonal folded in (Haar-distributed, as ``jax.nn.initializers.orthogonal``)."""
    tall = n_rows >= n_cols
    a = torch.randn((n_rows, n_cols) if tall else (n_cols, n_rows), generator=generator)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    return gain * (q if tall else q.T)


def orthogonal_init(gain: float = 1.0):
    """Orthogonal init of a Linear weight ``[out, in]``: the JAX package
    draws its ``[in, out]`` kernel orthogonal, and this is its transpose."""

    def init_(t: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        with torch.no_grad():
            return t.copy_(_orthogonal(t.shape[1], t.shape[0], gain, generator).T)

    return init_


def delta_orthogonal_init(gain: float = 1.0):
    """Delta-orthogonal init of a conv weight ``[out, in, k...]``: the
    central tap holds an orthogonal matrix, every other tap is zero.  A 2-D
    weight gets ``orthogonal_init``."""
    ortho = orthogonal_init(gain)

    def init_(t: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        if t.dim() == 2:
            return ortho(t, generator)
        assert t.dim() >= 3, f"delta_orthogonal expects a conv weight, got {tuple(t.shape)}"
        with torch.no_grad():
            t.zero_()
            mid = tuple(k // 2 for k in t.shape[2:])
            ortho(t[(slice(None), slice(None)) + mid], generator)
        return t

    return init_


def build_init(cfg):
    """Config-driven weight initializer: ``init_(weight, generator)`` on a
    weight in torch layout (``[out, in, k...]``)."""
    if cfg is None:
        return None
    cfg = dict(cfg)
    kind = cfg.pop("type")
    if kind in ("orthogonal", "orthogonal_init"):
        return orthogonal_init(cfg.get("gain", 1.0))
    if kind in ("delta_orthogonal", "delta_orthogonal_init"):
        return delta_orthogonal_init(cfg.get("gain", 1.0))
    if kind in ("torch_default",):
        return lambda t, generator: torch_default_(t, math.prod(t.shape[1:]), generator)
    if kind in ("xavier_uniform", "xavier_init"):
        return lambda t, generator: torch.nn.init.xavier_uniform_(t, generator=generator)
    raise KeyError(f"Unknown init type {kind}")
