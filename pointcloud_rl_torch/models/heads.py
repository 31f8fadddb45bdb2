"""Regression heads (port of ``pointcloud_rl_tpu/models/heads.py``).

``forward(feature, mode, generator)`` takes the JAX heads' modes: a mode
is one or more parts joined by "_" ("mean"/"eval", "explore"/"sample",
"std", "dist", "entropy"; the discrete head's "greedy", "p", "logits",
...), and "max-entropy" is the reparameterised sample with its negative
log-prob, shaped ``[..., 1]`` (the discrete head: probabilities and
entropy).  The JAX heads' "log_std" part can never be asked for (the mode
splits on "_" into "log" and "std", and "log" raises), so it is not
ported; "log_std" raises the same ``KeyError`` here.  The samplers are looked up in this module's namespace at
call time, so a test can pin the noise by patching them here, as the JAX
tests do for the JAX heads.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch import nn

from . import REGRESSION
from .distributions import (  # noqa: F401  (module-level names the tests may patch)
    categorical_entropy,
    categorical_probs,
    categorical_sample,
    normal_entropy,
    scaled_normal_rsample,
    scaled_normal_rsample_with_log_prob,
    tanh_normal_mean,
    tanh_normal_rsample_with_log_prob,
    tanh_normal_sample,
)


def _parts(mode: str, max_entropy_parts: Sequence[str]):
    return list(max_entropy_parts) if mode == "max-entropy" else mode.split("_")


class ContinuousHeadBase(nn.Module):
    """Bound handling (scale and bias of the action box; ``clip_return``
    clamps to it)."""

    def __init__(self, dim_output: int, bound: Optional[Any] = None, clip_return: bool = False,
                 num_heads: int = 1):
        super().__init__()
        self.dim_output = int(dim_output)
        self.clip_return = bool(clip_return)
        self.num_heads = int(num_heads)
        if bound is None:
            lb = ub = None
            scale, bias = np.ones(self.dim_output, np.float32), np.zeros(self.dim_output, np.float32)
        else:
            lb = np.broadcast_to(np.asarray(bound[0], np.float32), (self.dim_output,))
            ub = np.broadcast_to(np.asarray(bound[1], np.float32), (self.dim_output,))
            scale, bias = (ub - lb) / 2.0, (ub + lb) / 2.0
        self.has_bounds = bound is not None
        for name, value in (("lb", lb), ("ub", ub), ("scale", scale), ("bias", bias)):
            self.register_buffer(name, None if value is None else torch.as_tensor(np.array(value)),
                                 persistent=False)

    def clamp(self, x):
        if self.clip_return and self.has_bounds:
            x = x.clamp(self.lb, self.ub)
        return x

    def _log_std_param(self, predict_std: bool, init_log_std: float):
        if not predict_std:
            self.log_std = nn.Parameter(torch.full((1, self.dim_output), float(init_log_std)))

    def _mean_log_std(self, feature, predict_std: bool):
        if predict_std:
            assert feature.shape[-1] == 2 * self.dim_output, f"{feature.shape} vs 2*{self.dim_output}"
            return feature.chunk(2, dim=-1)
        return feature, self.log_std.expand(feature.shape)


@REGRESSION.register_module()
class TanhGaussianHead(ContinuousHeadBase):
    """SAC squashed Gaussian.  With ``predict_std`` the feature is
    concat(mean, log_std), else a learned ``log_std`` parameter; log_std is
    clamped to ``log_std_bound`` before exp."""

    def __init__(self, dim_output: int, bound: Optional[Any] = None, predict_std: bool = True,
                 init_log_std: float = -0.5, log_std_bound: Sequence[float] = (-20.0, 2.0),
                 epsilon: float = 1e-6, clip_return: bool = False, num_heads: int = 1):
        super().__init__(dim_output, bound, clip_return, num_heads)
        self.predict_std = bool(predict_std)
        self.log_std_bound = (float(log_std_bound[0]), float(log_std_bound[1]))
        self.epsilon = float(epsilon)
        self._log_std_param(self.predict_std, init_log_std)

    def forward(self, feature, mode: str = "explore", generator: Optional[torch.Generator] = None):
        mean, log_std = self._mean_log_std(feature, self.predict_std)
        std = log_std.clamp(self.log_std_bound[0], self.log_std_bound[1]).exp()
        ret = []
        for m in _parts(mode, ["rsample-with-neg-logp"]):
            if m in ("mean", "eval"):
                ret.append(tanh_normal_mean(mean, self.scale, self.bias))
            elif m in ("explore", "sample"):
                ret.append(tanh_normal_sample(generator, mean, std, self.scale, self.bias))
            elif m == "rsample-with-neg-logp":
                action, log_p = tanh_normal_rsample_with_log_prob(generator, mean, std, self.scale, self.bias,
                                                                  self.epsilon)
                ret.extend([action, -log_p[..., None]])
            elif m == "std":
                ret.append(std)
            elif m == "dist":
                ret.append((mean, std))
            elif m == "entropy":
                ret.append(normal_entropy(std).sum(-1))
            else:
                raise KeyError(f"Unknown head mode part: {m}")
        return ret[0] if len(ret) == 1 else tuple(ret)


@REGRESSION.register_module()
class GaussianHead(ContinuousHeadBase):
    """Unsquashed Gaussian with a tanh-bounded mean."""

    def __init__(self, dim_output: int, bound: Optional[Any] = None, predict_std: bool = True,
                 init_log_std: float = -0.5, log_std_bound: Sequence[float] = (-20.0, 2.0),
                 clip_return: bool = True, num_heads: int = 1):
        super().__init__(dim_output, bound, clip_return, num_heads)
        self.predict_std = bool(predict_std)
        self.log_std_bound = (float(log_std_bound[0]), float(log_std_bound[1]))
        self._log_std_param(self.predict_std, init_log_std)

    def forward(self, feature, mode: str = "explore", generator: Optional[torch.Generator] = None):
        mean, log_std = self._mean_log_std(feature, self.predict_std)
        std = log_std.clamp(self.log_std_bound[0], self.log_std_bound[1]).exp()
        if self.has_bounds:
            mean = torch.tanh(mean)
        return _scaled_normal_parts(self, mode, mean, std, generator)


@REGRESSION.register_module()
class SoftplusGaussianHead(ContinuousHeadBase):
    """PETS-style Gaussian: log_var softly clamped between two trainable
    per-dimension bounds by softplus from both sides."""

    def __init__(self, dim_output: int, bound: Optional[Any] = None, predict_std: bool = True,
                 init_log_std: float = -0.5, log_std_bound: Sequence[float] = (-20.0, 2.0),
                 init_log_var_min: float = -1.0, init_log_var_max: float = 0.5, clip_return: bool = False,
                 num_heads: int = 1):
        super().__init__(dim_output, bound, clip_return, num_heads)
        assert predict_std, "SoftplusGaussianHead predicts its std"
        self.log_std_bound = (float(log_std_bound[0]), float(log_std_bound[1]))
        self.log_var_min = nn.Parameter(torch.full((1, self.dim_output), float(init_log_var_min)))
        self.log_var_max = nn.Parameter(torch.full((1, self.dim_output), float(init_log_var_max)))

    def forward(self, feature, mode: str = "explore", generator: Optional[torch.Generator] = None):
        assert feature.shape[-1] == 2 * self.dim_output
        mean, log_std = feature.chunk(2, dim=-1)
        log_var = 2.0 * log_std.clamp(self.log_std_bound[0], self.log_std_bound[1])
        log_var = self.log_var_max - torch.nn.functional.softplus(self.log_var_max - log_var)
        log_var = self.log_var_min + torch.nn.functional.softplus(log_var - self.log_var_min)
        std = torch.exp(log_var / 2.0)
        return _scaled_normal_parts(self, mode, mean, std, generator)


def _scaled_normal_parts(head: ContinuousHeadBase, mode: str, mean, std, generator):
    """The mode parts of the two ScaledNormal heads: N(loc, std * scale)
    with loc = mean * scale + bias; "eval" and "explore" clamp."""
    scale, bias = head.scale, head.bias
    loc = mean * scale + bias
    ret = []
    for m in _parts(mode, ["rsample-with-neg-logp"]):
        if m in ("mean", "eval"):
            ret.append(head.clamp(loc))
        elif m in ("explore", "sample"):
            ret.append(head.clamp(scaled_normal_rsample(generator, mean, std, scale, bias)))
        elif m == "rsample-with-neg-logp":
            action, log_p = scaled_normal_rsample_with_log_prob(generator, mean, std, scale, bias)
            ret.extend([action, -log_p[..., None]])
        elif m == "std":
            ret.append(std * scale)
        elif m == "dist":
            ret.append((loc, std * scale))
        elif m == "entropy":
            ret.append(normal_entropy(std * scale).sum(-1))
        else:
            raise KeyError(f"Unknown head mode part: {m}")
    return ret[0] if len(ret) == 1 else tuple(ret)


@REGRESSION.register_module()
class BasicHead(ContinuousHeadBase):
    """Deterministic pass-through head (clamped with ``clip_return``)."""

    def forward(self, feature, mode: str = "eval", generator: Optional[torch.Generator] = None):
        return self.clamp(feature)


@REGRESSION.register_module()
class TanhHead(ContinuousHeadBase):
    """Deterministic tanh-squashed head."""

    def forward(self, feature, mode: str = "eval", generator: Optional[torch.Generator] = None):
        return torch.tanh(feature) * self.scale + self.bias


@REGRESSION.register_module()
class DiscreteBaseHead(nn.Module):
    """Categorical policy over logits.  ``max-entropy`` returns (probs,
    entropy[..., None]), the discrete-SAC contract."""

    def __init__(self, num_choices: int, num_heads: int = 1):
        super().__init__()
        self.num_choices = int(num_choices)
        self.num_heads = int(num_heads)

    def forward(self, feature, mode: str = "explore", generator: Optional[torch.Generator] = None):
        assert feature.shape[-1] == self.num_choices * self.num_heads
        logits = feature
        ret = []
        for m in _parts(mode, ["p", "entropy"]):
            if m in ("mean", "eval", "greedy"):
                ret.append(logits.argmax(dim=-1, keepdim=True))
            elif m in ("explore", "sample"):
                ret.append(categorical_sample(generator, logits)[..., None])
            elif m in ("prob", "p"):
                ret.append(categorical_probs(logits))
            elif m == "entropy":
                ret.append(categorical_entropy(logits)[..., None])
            elif m in ("feature", "logits"):
                ret.append(logits)
            else:
                raise KeyError(f"Unknown head mode part: {m}")
        return ret[0] if len(ret) == 1 else tuple(ret)
