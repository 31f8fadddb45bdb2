"""Recurrent core (port of ``pointcloud_rl_tpu/models/rnn.py``).

``GRU`` (registered also as ``RNN``) keeps the JAX module's contract:

* step mode: feat ``[B, D]`` and a state ``[B, L, H]`` -> feat ``[B, H]``
  and the new state, with the state zeroed where ``episode_dones`` is set,
  BEFORE the step;
* sequence mode: feat ``[B, T, D]`` -> ``[B, T, H]``, a loop over T with
  the same reset.
``rnn_mode="base"`` returns the features; ``"with_states"`` returns
``(features, final_state)``.

Each cell is flax's ``GRUCell``: six Dense layers named as flax names them
(``ir``, ``iz``, ``in`` with a bias; ``hr``, ``hz`` without; ``hn`` with
one), computing ``r = sigmoid(ir(x) + hr(h))``, ``z = sigmoid(iz(x) +
hz(h))``, ``n = tanh(in(x) + r * hn(h))`` and ``h' = (1 - z) n + z h``.
``torch.nn.GRUCell`` computes the same function but trains a bias in ``hr``
and ``hz`` as well, whose gradient equals that of ``ir``'s and ``iz``'s
biases, so Adam would move the effective bias twice per step; hence the
cell of six ``Linear``s.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from . import NETWORK
from .init import orthogonal_init


class GRUCell(nn.Module):
    def __init__(self, in_features: int, hidden_size: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        for name in ("ir", "iz", "in"):
            self.add_module(name, nn.Linear(in_features, hidden_size))
        for name in ("hr", "hz"):
            self.add_module(name, nn.Linear(hidden_size, hidden_size, bias=False))
        self.add_module("hn", nn.Linear(hidden_size, hidden_size))
        # flax's inits: lecun-normal input kernels, orthogonal recurrent
        # kernels, zero biases (the values differ from the JAX draws).
        ortho = orthogonal_init()
        with torch.no_grad():
            for name in ("ir", "iz", "in", "hr", "hz", "hn"):
                layer = getattr(self, name)
                if name.startswith("i"):
                    std = math.sqrt(1.0 / in_features) / 0.87962566103423978
                    nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
                else:
                    ortho(layer.weight, generator)
                if layer.bias is not None:
                    layer.bias.zero_()

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(getattr(self, "in")(x) + r * self.hn(h))
        return (1.0 - z) * n + z * h


@NETWORK.register_module(name="RNN")
@NETWORK.register_module()
class GRU(nn.Module):
    def __init__(self, hidden_size: int, num_layers: int = 1, in_features: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        assert in_features is not None, "GRU needs in_features (the builder passes the rnn input width)"
        self.hidden_size = int(hidden_size)
        self.num_layers = int(num_layers)
        for i in range(self.num_layers):
            width = in_features if i == 0 else self.hidden_size
            self.add_module(f"layer_{i}", GRUCell(width, self.hidden_size, generator))

    def initial_state(self, batch: int, device=None) -> torch.Tensor:
        return torch.zeros((batch, self.num_layers, self.hidden_size), device=device)

    def _step(self, carry: torch.Tensor, x: torch.Tensor, done: Optional[torch.Tensor] = None):
        """carry [B, L, H]; x [B, D]; done [B, 1] resets BEFORE the step."""
        if done is not None:
            carry = carry * (1.0 - done.to(carry.dtype))[..., None]
        layers, h = [], x
        for i in range(self.num_layers):
            h = getattr(self, f"layer_{i}")(carry[:, i], h)
            layers.append(h)
        return torch.stack(layers, dim=1), h

    def forward(self, feat, rnn_states=None, episode_dones=None, rnn_mode: str = "base"):
        B = feat.shape[0]
        if rnn_states is None:
            rnn_states = self.initial_state(B, feat.device)
        if feat.dim() != 3:
            state, out = self._step(rnn_states, feat, episode_dones)
            return out if rnn_mode == "base" else (out, state)
        T = feat.shape[1]
        dones = None if episode_dones is None else episode_dones.float().reshape(B, T, 1)
        state, outs = rnn_states, []
        for t in range(T):
            state, out = self._step(state, feat[:, t], None if dones is None else dones[:, t])
            outs.append(out)
        outs = torch.stack(outs, dim=1)
        return outs if rnn_mode == "base" else (outs, state)
