"""Dense/MLP building blocks (port of ``pointcloud_rl_tpu/models/blocks.py``).

One channel-last MLP over the trailing axis serves ``MLP``, ``LinearMLP``
and ``ConvMLP`` (a 1x1 Conv1d over ``[B, C, N]`` is a Linear over
``[B, N, C]``).  Layers are registered under the flax module names of the
JAX package (``Dense_0``, ``LayerNorm_0``, ...; LayerNorms are counted
separately), so a parameter's name maps one to one onto its flax path.

``num_heads`` stacks that many independent MLPs into one module, with
kernels ``[heads, in, out]`` applied by a batched matmul: the port of the
JAX critic's ``nn.vmap``-ed ensemble.

``dtype="bfloat16"`` is the mixed-precision policy of the JAX package's
``DenseBlock``: parameters stay f32, each Dense casts its input, kernel and
bias to bf16 and emits bf16, LayerNorm runs (and emits) f32, and the MLP's
output is cast back to f32 for the heads and losses.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from . import NETWORK
from .init import torch_default_, uniform_


def get_activation(act_cfg) -> Optional[Callable]:
    if act_cfg is None:
        return None
    name = act_cfg["type"] if isinstance(act_cfg, Mapping) else act_cfg
    table = {
        "ReLU": torch.relu,
        "GELU": lambda x: F.gelu(x, approximate="tanh"),  # flax nn.gelu is the tanh form
        "SiLU": F.silu,
        "Tanh": torch.tanh,
        "Sigmoid": torch.sigmoid,
        "ELU": F.elu,
        "LeakyReLU": lambda x: F.leaky_relu(x, negative_slope=0.01),
        "Softplus": F.softplus,
        "Identity": lambda x: x,
    }
    if name not in table:
        raise KeyError(f"Unknown activation {name}")
    return table[name]


def norm_kind_and_eps(norm_cfg) -> Tuple[Optional[str], float]:
    """LN/LN1d/LN2d/LN3d (and BN, as in the JAX package) all mean LayerNorm
    over the channel axis; the default eps is 1e-5."""
    if norm_cfg is None:
        return None, 1e-5
    is_map = isinstance(norm_cfg, Mapping)
    kind = norm_cfg["type"] if is_map else norm_cfg
    eps = norm_cfg.get("eps", 1e-5) if is_map else 1e-5
    if kind.startswith("LN") or kind.startswith("BN") or kind == "SyncBN":
        return "LN", eps
    raise KeyError(f"Unknown norm type {kind}")


def resolve_dtype(dtype) -> Optional[torch.dtype]:
    """The matmul compute dtype of a config's ``dtype``: None (f32) for
    None/"float32", torch.bfloat16 for "bfloat16"."""
    if dtype in (None, "float32", torch.float32):
        return None
    if dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    raise NotImplementedError(f"dtype={dtype!r}: the port computes in float32 or bfloat16")


def dense(layer: nn.Module, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``layer`` (an ``nn.Linear`` or a ``StackedDense``) on ``x``, in the
    compute dtype: None runs it as is, in f32; bf16 casts input, kernel and
    bias to bf16 (the parameters stay f32) and emits bf16.  As in flax's
    Dense, the product is rounded to bf16 before the bias is added."""
    if dtype is None:
        return layer(x.float())
    x, w = x.to(dtype), layer.weight.to(dtype)
    y = torch.bmm(x, w) if isinstance(layer, StackedDense) else F.linear(x, w)
    if layer.bias is None:
        return y
    b = layer.bias.to(dtype)
    return y + (b[:, None, :] if isinstance(layer, StackedDense) else b)


class StackedDense(nn.Module):
    """``heads`` independent Linear layers: x [heads, B, in] -> [heads, B, out]."""

    def __init__(self, heads: int, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(heads, in_features, out_features))
        self.bias = nn.Parameter(torch.empty(heads, out_features)) if bias else None

    def forward(self, x):
        if self.bias is None:
            return torch.bmm(x, self.weight)
        return torch.baddbmm(self.bias[:, None, :], x, self.weight)


class StackedLayerNorm(nn.Module):
    """``heads`` independent LayerNorms over the last axis of [heads, B, C]."""

    def __init__(self, heads: int, channels: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(heads, channels))
        self.bias = nn.Parameter(torch.zeros(heads, channels))

    def forward(self, x):
        x = F.layer_norm(x, x.shape[-1:], eps=self.eps)
        return x * self.weight[:, None, :] + self.bias[:, None, :]


@NETWORK.register_module()
class MLP(nn.Module):
    """Configurable MLP over the trailing axis (works on [B, D] and [B, N, D]).

    ``inactivated_output`` drops norm and activation on the last layer;
    ``ignore_first_ln`` drops the norm on the first layer;
    ``zero_out_indices`` re-initialises that slice of the last layer's
    outputs near zero (the log-std trick).
    """

    def __init__(
        self,
        mlp_spec: Sequence[int],
        norm_cfg: Optional[Any] = None,
        act_cfg: Optional[Any] = "ReLU",
        bias: Union[str, bool] = "auto",
        inactivated_output: bool = True,
        ignore_first_ln: bool = False,
        zero_out_indices: Optional[Any] = None,
        dtype: Optional[Any] = None,
        num_heads: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.compute_dtype = resolve_dtype(dtype)
        self.spec = [int(c) for c in mlp_spec]
        self.num_heads = num_heads
        norm_kind, eps = norm_kind_and_eps(norm_cfg)
        use_bias = bias if isinstance(bias, bool) else True
        n_layers = len(self.spec) - 1
        # (dense name, norm name or None, activation) per layer
        self.plan = []
        n_ln = 0
        for i in range(n_layers):
            is_last = i == n_layers - 1
            no_norm = (is_last and inactivated_output) or (i == 0 and ignore_first_ln)
            act = None if (is_last and inactivated_output) else act_cfg
            c_in, c_out = self.spec[i], self.spec[i + 1]
            if num_heads is None:
                dense = nn.Linear(c_in, c_out, bias=use_bias)
                kernel = dense.weight  # [out, in]
            else:
                dense = StackedDense(num_heads, c_in, c_out, bias=use_bias)
                kernel = dense.weight  # [heads, in, out]
            torch_default_(kernel, c_in, generator)
            if dense.bias is not None:
                torch_default_(dense.bias, c_in, generator)
            if is_last and zero_out_indices is not None:
                z = zero_out_indices
                small = uniform_(torch.empty_like(kernel), 1e-3, generator)
                with torch.no_grad():
                    if num_heads is None:
                        kernel[z, :] = small[z, :]
                    else:
                        kernel[..., z] = small[..., z]
                    if dense.bias is not None:
                        small_b = uniform_(torch.empty_like(dense.bias), 1e-3, generator)
                        dense.bias[..., z] = small_b[..., z]
            self.add_module(f"Dense_{i}", dense)
            norm_name = None
            if norm_kind == "LN" and not no_norm:
                norm_name = f"LayerNorm_{n_ln}"
                n_ln += 1
                ln = (nn.LayerNorm(c_out, eps=eps) if num_heads is None
                      else StackedLayerNorm(num_heads, c_out, eps))
                self.add_module(norm_name, ln)
            self.plan.append((f"Dense_{i}", norm_name, get_activation(act)))

    def forward(self, x):
        assert x.shape[-1] == self.spec[0], f"MLP input dim {x.shape[-1]} != spec[0] {self.spec[0]}"
        lead = x.shape[:-1]
        if self.num_heads is not None:
            x = x.reshape(-1, x.shape[-1]).expand(self.num_heads, -1, -1)  # [heads, rows, D]
        for layer, norm, act in self.plan:
            x = dense(getattr(self, layer), x, self.compute_dtype)
            if norm is not None:
                x = getattr(self, norm)(x.float())
            if act is not None:
                x = act(x)
        if self.num_heads is not None:
            x = x.movedim(0, -2).reshape(*lead, self.num_heads, -1)  # [..., heads, out]
        return x.float()


@NETWORK.register_module()
class LinearMLP(MLP):
    """Alias of MLP on [B, D] features."""


@NETWORK.register_module()
class ConvMLP(MLP):
    """Per-point shared MLP over channel-last [B, N, C]."""
