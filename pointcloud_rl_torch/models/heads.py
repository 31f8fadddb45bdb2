"""Regression heads (port of ``TanhGaussianHead`` in
``pointcloud_rl_tpu/models/heads.py:73-126``).

``forward(feature, mode, generator)`` takes the modes SAC uses:
"mean"/"eval", "explore"/"sample" and "max-entropy" (a reparameterised
sample and its negative log-prob, shaped ``[..., 1]``).  The
samplers are looked up in this module's namespace at call time, so a test
can pin the noise by patching ``tanh_normal_rsample_with_log_prob`` here,
as the JAX tests do for the JAX head.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch import nn

from . import REGRESSION
from .distributions import (  # noqa: F401  (module-level names the tests may patch)
    tanh_normal_mean,
    tanh_normal_rsample_with_log_prob,
    tanh_normal_sample,
)


def _bound_scale_bias(bound, dim_output):
    if bound is None:
        return None, np.ones(dim_output, np.float32), np.zeros(dim_output, np.float32)
    lb = np.broadcast_to(np.asarray(bound[0], np.float32), (dim_output,))
    ub = np.broadcast_to(np.asarray(bound[1], np.float32), (dim_output,))
    return (lb, ub), (ub - lb) / 2.0, (ub + lb) / 2.0


@REGRESSION.register_module()
class TanhGaussianHead(nn.Module):
    """SAC squashed Gaussian.  The feature is concat(mean, log_std); log_std
    is clamped to ``log_std_bound`` before exp."""

    def __init__(
        self,
        dim_output: int,
        bound: Optional[Any] = None,
        predict_std: bool = True,
        log_std_bound: Sequence[float] = (-20.0, 2.0),
        epsilon: float = 1e-6,
    ):
        super().__init__()
        if not predict_std:
            raise NotImplementedError("TanhGaussianHead(predict_std=False) is not ported to "
                                      "pointcloud_rl_torch yet (ROADMAP.md queue A, item A4)")
        self.dim_output = int(dim_output)
        self.log_std_bound = (float(log_std_bound[0]), float(log_std_bound[1]))
        self.epsilon = float(epsilon)
        _, scale, bias = _bound_scale_bias(bound, self.dim_output)
        self.register_buffer("scale", torch.as_tensor(np.array(scale)), persistent=False)
        self.register_buffer("bias", torch.as_tensor(np.array(bias)), persistent=False)

    def forward(self, feature, mode: str = "explore", generator: Optional[torch.Generator] = None):
        assert feature.shape[-1] == 2 * self.dim_output, f"{feature.shape} vs 2*{self.dim_output}"
        mean, log_std = feature.chunk(2, dim=-1)
        std = log_std.clamp(self.log_std_bound[0], self.log_std_bound[1]).exp()
        if mode in ("mean", "eval"):
            return tanh_normal_mean(mean, self.scale, self.bias)
        if mode in ("explore", "sample"):
            return tanh_normal_sample(generator, mean, std, self.scale, self.bias)
        if mode == "max-entropy":
            action, log_p = tanh_normal_rsample_with_log_prob(generator, mean, std, self.scale, self.bias,
                                                              self.epsilon)
            return action, -log_p[..., None]
        raise NotImplementedError(f"TanhGaussianHead mode {mode!r} is not ported to pointcloud_rl_torch "
                                  "(SAC uses eval, explore and max-entropy)")
