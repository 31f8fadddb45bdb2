"""2D CNN encoders: NatureCNN, DMCEncoder (SAC-AE), IMPALA (port of
``pointcloud_rl_tpu/models/cnn.py``).

Observations arrive channel-first ``[B, C, H, W]`` (the env contract) and
are moved once to NHWC, the layout of the JAX package.  Each conv reads the
NHWC tensor through an NCHW view (``channels_last`` strides) and its output
is viewed back as NHWC, so LayerNorms run over the channel axis and the
flatten before the first Dense sees ``(h, w, c)`` order, as flax's does.
Convs run through ``ops/conv.py`` (f32, whatever the process's TF32 flags).
Modules carry the flax names (``Conv_0``, ``LayerNorm_0``, ``Dense_0``,
``_ImpalaBlock_0``), so ``convert.params_from_jax`` maps them one to one.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import conv
from . import NETWORK
from .blocks import get_activation, norm_kind_and_eps
from .init import build_init, torch_default_

_DENSE_LN_EPS = 1e-6  # flax LayerNorm's default (DMCEncoder's output norm)


def preprocess_images(obs) -> torch.Tensor:
    """Concat rgb/255 (uint8 rgb only) + depth + xyz + seg channel-wise; output NHWC f32."""
    if isinstance(obs, dict):
        feats = []
        if "rgb" in obs:
            rgb = obs["rgb"]
            feats.append(rgb.float() / 255.0 if rgb.dtype == torch.uint8 else rgb.float())
        for key in ("depth", "xyz", "seg"):
            if key in obs:
                feats.append(obs[key].float())
        x = torch.cat(feats, dim=-3)
    else:
        x = obs.float() / 255.0 if obs.dtype == torch.uint8 else obs.float()
    return x.movedim(-3, -1).contiguous()


def _conv_layer(in_ch: int, out_ch: int, kernel: int, generator, kernel_init=None) -> nn.Conv2d:
    """A Conv2d holding the weight [out, in, k, k] and bias, torch-default
    initialised (fan_in = in * k * k) unless ``kernel_init`` fills the weight."""
    layer = nn.Conv2d(in_ch, out_ch, kernel)
    fan_in = in_ch * kernel * kernel
    if kernel_init is not None:
        kernel_init(layer.weight, generator)
    else:
        torch_default_(layer.weight, fan_in, generator)
    torch_default_(layer.bias, fan_in, generator)
    return layer


def _apply_conv(layer: nn.Conv2d, x: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """NHWC in, NHWC out."""
    y = conv(x.permute(0, 3, 1, 2), layer.weight, layer.bias, (stride, stride), (padding, padding))
    return y.permute(0, 2, 3, 1)


def _out_size(n: int, kernel: int, stride: int, padding: int) -> int:
    return (n + 2 * padding - kernel) // stride + 1


def _dense(in_features: int, out_features: int, generator) -> nn.Linear:
    layer = nn.Linear(in_features, out_features)
    torch_default_(layer.weight, in_features, generator)
    torch_default_(layer.bias, in_features, generator)
    return layer


@NETWORK.register_module()
class NatureCNN(nn.Module):
    """DQN-style configurable conv stack + flatten + Linear."""

    def __init__(
        self,
        in_channels: int,
        image_size: Sequence[int],
        out_channels: Optional[int] = 512,
        mlp_spec: Sequence[int] = (32, 64, 64),
        kernel_size: Sequence[int] = (8, 4, 2),
        stride: Sequence[int] = (4, 2, 1),
        padding: Optional[Sequence[int]] = None,
        norm_cfg: Optional[Any] = None,
        act_cfg: Any = "ReLU",
        ignore_first_ln: bool = True,
        flatten: bool = True,
        inactivate_output: bool = False,
        conv_init_cfg: Optional[Any] = None,  # config parity; unused, as in the JAX package
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.act = get_activation(act_cfg)
        norm_kind, eps = norm_kind_and_eps(norm_cfg)
        self.padding = list(padding or [0] * len(kernel_size))
        self.kernel_size, self.stride = list(kernel_size), list(stride)
        self.out_channels, self.inactivate_output, self.flatten = out_channels, inactivate_output, flatten
        n = len(mlp_spec)
        in_ch, (h, w) = in_channels, image_size
        self.plan = []  # (conv name, norm name or None, activate)
        n_ln = 0
        for i in range(n):
            self.add_module(f"Conv_{i}", _conv_layer(in_ch, mlp_spec[i], kernel_size[i], generator))
            h, w = (_out_size(s, kernel_size[i], stride[i], self.padding[i]) for s in (h, w))
            in_ch = mlp_spec[i]
            norm = None
            if norm_kind == "LN" and not (i == 0 and ignore_first_ln):
                norm = f"LayerNorm_{n_ln}"
                n_ln += 1
                self.add_module(norm, nn.LayerNorm(in_ch, eps=eps))
            last = i == n - 1
            activate = not (last and inactivate_output and out_channels is None) and self.act is not None
            self.plan.append((f"Conv_{i}", norm, activate))
        if out_channels is not None:
            self.Dense_0 = _dense(h * w * in_ch, out_channels, generator)

    def forward(self, obs):
        x = preprocess_images(obs)
        for i, (name, norm, activate) in enumerate(self.plan):
            x = _apply_conv(getattr(self, name), x, self.stride[i], self.padding[i])
            if norm is not None:
                x = getattr(self, norm)(x)
            if activate:
                x = self.act(x)
        if self.flatten or self.out_channels is not None:
            x = x.reshape(x.shape[0], -1)
        if self.out_channels is not None:
            x = self.Dense_0(x)
            if not self.inactivate_output and self.act is not None:
                x = self.act(x)
        return x


@NETWORK.register_module()
class DMCEncoder(nn.Module):
    """SAC-AE encoder for DM Control: 4 conv(32, k3), stride [2,1,1,1],
    flatten, Linear(out) + LayerNorm, no output activation.

    ``conv_init_cfg`` (e.g. delta_orthogonal_init, gain 1.414) fills the
    conv weights; ``norm_cfg`` (LN2d) adds a LayerNorm after each conv."""

    def __init__(
        self,
        in_channels: int,
        image_size: Sequence[int],
        out_channels: int = 50,
        mlp_spec: Sequence[int] = (32, 32, 32, 32),
        kernel_size: Sequence[int] = (3, 3, 3, 3),
        stride: Sequence[int] = (2, 1, 1, 1),
        act_cfg: Any = "ReLU",
        norm_cfg: Optional[Any] = None,
        conv_init_cfg: Optional[Any] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.act = get_activation(act_cfg)
        norm_kind, eps = norm_kind_and_eps(norm_cfg)
        self.use_norm = norm_kind == "LN"
        self.stride = list(stride)
        conv_init = build_init(conv_init_cfg)
        in_ch, (h, w) = in_channels, image_size
        for i, (ch, k, s) in enumerate(zip(mlp_spec, kernel_size, stride)):
            self.add_module(f"Conv_{i}", _conv_layer(in_ch, ch, k, generator, conv_init))
            if self.use_norm:
                self.add_module(f"LayerNorm_{i}", nn.LayerNorm(ch, eps=eps))
            h, w = _out_size(h, k, s, 0), _out_size(w, k, s, 0)
            in_ch = ch
        self.n_conv = len(mlp_spec)
        self.Dense_0 = _dense(h * w * in_ch, out_channels, generator)
        self.out_norm = f"LayerNorm_{self.n_conv if self.use_norm else 0}"
        self.add_module(self.out_norm, nn.LayerNorm(out_channels, eps=_DENSE_LN_EPS))

    def forward(self, obs):
        x = preprocess_images(obs)
        for i in range(self.n_conv):
            x = _apply_conv(getattr(self, f"Conv_{i}"), x, self.stride[i], 0)
            if self.use_norm:
                x = getattr(self, f"LayerNorm_{i}")(x)
            x = self.act(x)
        x = self.Dense_0(x.reshape(x.shape[0], -1))
        return getattr(self, self.out_norm)(x)


class _ImpalaBlock(nn.Module):
    def __init__(self, channels: int, generator):
        super().__init__()
        self.Conv_0 = _conv_layer(channels, channels, 3, generator)
        self.Conv_1 = _conv_layer(channels, channels, 3, generator)

    def forward(self, x):
        y = _apply_conv(self.Conv_0, torch.relu(x), 1, 1)
        y = _apply_conv(self.Conv_1, torch.relu(y), 1, 1)
        return x + y


@NETWORK.register_module()
class IMPALA(nn.Module):
    """IMPALA resnet encoder: 4x4/s4 stem, then per stage conv3 + maxpool/2
    + two residual blocks; ReLU -> flatten -> fc.  ``num_pixels`` is the
    square image's H * W."""

    _STAGES = (64, 64, 64)

    def __init__(self, in_channel: int, num_pixels: int, out_feature_size: int = 256,
                 out_channel: Optional[int] = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        side = math.isqrt(int(num_pixels))
        if side * side != num_pixels:
            raise ValueError(f"IMPALA: num_pixels={num_pixels} is not a square image's H * W")
        self.Conv_0 = _conv_layer(in_channel, self._STAGES[0], 4, generator)
        side = _out_size(side, 4, 4, 0)
        in_ch = self._STAGES[0]
        for i, ch in enumerate(self._STAGES):
            self.add_module(f"Conv_{i + 1}", _conv_layer(in_ch, ch, 3, generator))
            self.add_module(f"_ImpalaBlock_{2 * i}", _ImpalaBlock(ch, generator))
            self.add_module(f"_ImpalaBlock_{2 * i + 1}", _ImpalaBlock(ch, generator))
            side = _out_size(side, 3, 2, 1)
            in_ch = ch
        self.Dense_0 = _dense(side * side * in_ch, out_feature_size, generator)
        self.out_channel = out_channel
        if out_channel is not None:
            self.Dense_1 = _dense(out_feature_size, out_channel, generator)

    def forward(self, obs):
        x = _apply_conv(self.Conv_0, preprocess_images(obs), 4, 0)
        for i in range(len(self._STAGES)):
            x = _apply_conv(getattr(self, f"Conv_{i + 1}"), x, 1, 1)
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
            x = getattr(self, f"_ImpalaBlock_{2 * i}")(x)
            x = getattr(self, f"_ImpalaBlock_{2 * i + 1}")(x)
        x = torch.relu(x).reshape(x.shape[0], -1)
        x = torch.relu(self.Dense_0(x))
        if self.out_channel is not None:
            x = self.Dense_1(x)
        return x
