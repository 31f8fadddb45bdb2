"""Policy distributions as functions over (mean, std) tensors.

Port of the ScaledTanhNormal part of ``pointcloud_rl_tpu/models/
distributions.py``: the SAC squashed Gaussian with the reference's
epsilon-in-log log-prob correction.  Log-probs sum over the last (action)
axis.  Noise is drawn from an explicit ``torch.Generator`` on the
tensors' device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def normal_log_prob(x, mean, std):
    return -((x - mean) ** 2) / (2 * std * std) - torch.log(std) - _LOG_SQRT_2PI


def standard_normal(like: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.randn(like.shape, generator=generator, device=like.device, dtype=like.dtype)


def tanh_transform(z, scale, bias):
    return torch.tanh(z) * scale + bias


def tanh_log_prob_with_logit(z, mean, std, scale, epsilon: float = 1e-6):
    """log-density of tanh(z)*scale+bias given the pre-tanh logit z:
    ``log p(z) - log(scale * (1 - tanh(z)^2) + eps)``, summed over actions."""
    log_p = normal_log_prob(z, mean, std)
    log_p = log_p - torch.log(scale * (1.0 - torch.tanh(z) ** 2) + epsilon)
    return log_p.sum(-1)


def tanh_normal_rsample_with_log_prob(generator, mean, std, scale, bias, epsilon: float = 1e-6):
    z = mean + std * standard_normal(mean, generator)
    return tanh_transform(z, scale, bias), tanh_log_prob_with_logit(z, mean, std, scale, epsilon)


def tanh_normal_sample(generator, mean, std, scale, bias):
    return tanh_transform(mean + std * standard_normal(mean, generator), scale, bias)


def tanh_normal_mean(mean, scale, bias):
    return tanh_transform(mean, scale, bias)
