"""Host-side agent plumbing (port of ``pointcloud_rl_tpu/algorithms/base.py``).

An agent lives on one explicit ``device``: observations come in as numpy
trees (or tensors), go to that device, and actions come back as numpy arrays.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def example_obs_from_shape(obs_shape, batch: int = 1):
    """A zero observation batch matching the env's obs shapes (rgb is uint8,
    as the env emits it)."""
    if isinstance(obs_shape, dict):
        out = {}
        for k, shape in obs_shape.items():
            shape = (shape,) if isinstance(shape, int) else tuple(shape)
            out[k] = np.zeros((batch,) + shape, np.uint8 if k == "rgb" else np.float32)
        return out
    shape = (obs_shape,) if isinstance(obs_shape, int) else tuple(obs_shape)
    return np.zeros((batch,) + shape, np.float32)


def to_torch(tree: Any, device: torch.device) -> Any:
    """numpy tree -> tensors on ``device`` (dtypes kept: uint8 rgb stays uint8).
    Tensors already on ``device`` (a device replay's batch) pass through."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return torch.as_tensor(np.asarray(tree)).to(device)


class BaseAgent:
    """Common host plumbing; algorithm classes implement ``act`` and the update."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' was asked for, but torch.cuda.is_available() is false")
        self.modules: Dict[str, torch.nn.Module] = {}
        self._rnn_states = None  # a recurrent agent's per-env state [B, L, H], threaded through act

    def train(self):
        for m in self.modules.values():
            m.train()
        return self

    def eval(self):
        for m in self.modules.values():
            m.eval()
        return self

    def act(self, obs, mode: str) -> torch.Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def forward(self, obs, mode: str = "explore", **kwargs) -> np.ndarray:
        """obs (numpy tree, batched) -> actions (numpy [B, A])."""
        return self.act(to_torch(obs, self.device), mode).cpu().numpy()

    def reset_rnn_states(self, dones=None) -> None:
        """Zero the recurrent states: all of them, or the rows of the envs
        whose ``dones`` ([B, 1]) are set."""
        if self._rnn_states is None:
            return
        if dones is None:
            self._rnn_states = None
        else:
            keep = 1.0 - torch.as_tensor(np.asarray(dones, np.float32)).reshape(-1, 1, 1)
            self._rnn_states = self._rnn_states * keep.to(self._rnn_states.device)

    def __call__(self, obs, mode: str = "explore", **kwargs):
        return self.forward(obs, mode=mode, **kwargs)

    def update_parameters(self, memory, updates: int) -> Dict[str, float]:
        raise NotImplementedError

    @property
    def num_params(self) -> int:
        model = self.modules.get("model")
        return 0 if model is None else int(sum(p.numel() for p in model.parameters()))
