"""Policy distributions as functions over (mean, std) tensors.

Port of ``pointcloud_rl_tpu/models/distributions.py``: ScaledTanhNormal
(the SAC squashed Gaussian with the reference's epsilon-in-log log-prob
correction), ScaledNormal, and the categorical helpers of discrete SAC.
Log-probs sum over the last (action) axis.  Every draw comes from an
explicit ``torch.Generator`` on the tensors' device, through one function
per kind of draw (``standard_normal``, ``standard_gumbel``), so a test
can pin the noise by patching the sampler that calls it.  The draws are
over the batch axis (``utils.draws.draw_rows``), so a data-parallel rank
draws the global batch's noise and keeps its rows.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..utils.draws import draw_rows

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def standard_normal(like: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    return draw_rows(lambda s: torch.randn(s, generator=generator, device=like.device, dtype=like.dtype), like.shape)


def standard_gumbel(like: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    u = draw_rows(lambda s: torch.rand(s, generator=generator, device=like.device, dtype=like.dtype), like.shape)
    tiny = torch.finfo(like.dtype).tiny
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def normal_log_prob(x, mean, std):
    return -((x - mean) ** 2) / (2 * std * std) - torch.log(std) - _LOG_SQRT_2PI


def normal_entropy(std):
    return 0.5 + _LOG_SQRT_2PI + torch.log(std)


# ---------------------------------------------------------------------------
# ScaledNormal: N(mean*scale+bias, std*scale)
# ---------------------------------------------------------------------------
def scaled_normal_rsample(generator, mean, std, scale, bias):
    return mean * scale + bias + std * scale * standard_normal(mean, generator)


def scaled_normal_log_prob(x, mean, std, scale, bias):
    return normal_log_prob(x, mean * scale + bias, std * scale).sum(-1)


def scaled_normal_rsample_with_log_prob(generator, mean, std, scale, bias):
    x = scaled_normal_rsample(generator, mean, std, scale, bias)
    return x, scaled_normal_log_prob(x, mean, std, scale, bias)


# ---------------------------------------------------------------------------
# ScaledTanhNormal: tanh(N(mean, std)) * scale + bias
# ---------------------------------------------------------------------------
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


def tanh_normal_log_prob(x, mean, std, scale, bias, epsilon: float = 1e-6):
    z = torch.atanh(((x - bias) / scale).clamp(-1.0 + 1e-6, 1.0 - 1e-6))
    return tanh_log_prob_with_logit(z, mean, std, scale, epsilon)


# ---------------------------------------------------------------------------
# Categorical (discrete SAC)
# ---------------------------------------------------------------------------
def categorical_sample(generator, logits):
    """Gumbel-max, as ``jax.random.categorical``."""
    return (logits + standard_gumbel(logits, generator)).argmax(dim=-1)


def categorical_probs(logits):
    return torch.softmax(logits, dim=-1)


def categorical_entropy(logits):
    logp = F.log_softmax(logits, dim=-1)
    return -(logp.exp() * logp).sum(-1)


def categorical_log_prob(logits, actions):
    logp = F.log_softmax(logits, dim=-1)
    actions = actions.long()
    if actions.dim() == logp.dim():
        actions = actions[..., 0]
    return logp.gather(-1, actions[..., None])[..., 0]
