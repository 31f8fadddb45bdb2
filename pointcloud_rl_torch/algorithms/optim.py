"""Optimizers with per-parameter regex config, and the per-path EMA.

Port of ``pointcloud_rl_tpu/algorithms/optim.py``.  ``optim_cfg`` dicts like
``dict(type="Adam", lr=1e-3, betas=(0.5, 0.999), param_cfg={"(.*?)visual_nn(.*?)":
None})``: a ``None`` value EXCLUDES the matching parameters, which then get
no update and no Adam state.  Regexes match the same slash-joined paths as
in the JAX package (``convert.regex_path``: the flax path, with the shared
visual subtree shown as ``visual_nn/...``), so config regexes work verbatim.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch

from ..convert import regex_path

NamedParams = Sequence[Tuple[str, torch.Tensor]]


def _first_match(patterns: Dict[str, object], path: str):
    for pat, val in patterns.items():
        if re.search(pat, path):
            return True, val
    return False, None


class Optimizer:
    """Adam over the parameters a config trains (the only optimizer the
    shipped configs use; the JAX package's SGD/RMSprop, weight decay and
    gradient clipping raise here)."""

    def __init__(self, optim_cfg: Optional[dict], named_params: NamedParams):
        cfg = dict(optim_cfg or {"type": "Adam", "lr": 3e-4})
        kind = cfg.pop("type", "Adam")
        lr = cfg.pop("lr", 3e-4)
        betas = tuple(cfg.pop("betas", (0.9, 0.999)))
        eps = cfg.pop("eps", 1e-8)
        param_cfg = cfg.pop("param_cfg", None) or {}
        if kind.lower() != "adam" or cfg:
            raise NotImplementedError(f"optimizer {kind!r} with {sorted(cfg)} is not ported to "
                                      "pointcloud_rl_torch (only Adam with lr, betas, eps, param_cfg)")
        self.names: List[str] = []
        self.params: List[torch.Tensor] = []
        for name, p in named_params:
            matched, val = _first_match(param_cfg, regex_path(name))
            if matched and val is None:
                continue
            self.names.append(name)
            self.params.append(p)
        # torch Adam's step is optax.adam's: lr * m_hat / (sqrt(v_hat) + eps)
        self.opt = torch.optim.Adam(self.params, lr=lr, betas=betas, eps=eps) if self.params else None

    def step(self, grads: Sequence[Optional[torch.Tensor]]) -> None:
        """One step with ``grads`` aligned to ``self.params`` (None = zero,
        as a leaf without a gradient gets a zero update from optax)."""
        if self.opt is None:
            return
        for p, g in zip(self.params, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        self.opt.step()
        for p in self.params:
            p.grad = None

    def state_dict(self):
        return self.opt.state_dict() if self.opt is not None else {}

    def load_state_dict(self, state) -> None:
        if self.opt is not None:
            self.opt.load_state_dict(state)


def build_tau_tree(update_coeff: Union[float, Dict[str, float]], names: Iterable[str]) -> Dict[str, float]:
    """Per-parameter EMA rate from a float or a regex dict (``default`` key)."""
    names = list(names)
    if not isinstance(update_coeff, dict):
        return {n: float(update_coeff) for n in names}
    default = float(update_coeff.get("default", 0.005))

    def _tau(path: str) -> float:
        for pat, val in update_coeff.items():
            if pat != "default" and re.search(pat, path):
                return float(val)
        return default

    return {n: _tau(regex_path(n)) for n in names}


@torch.no_grad()
def soft_update(target: torch.nn.Module, live: torch.nn.Module, taus: Dict[str, float]) -> None:
    """target <- (1 - tau) * target + tau * live, per parameter, in place.

    ``target``'s parameter names are looked up in ``live`` (the target owns
    a subset of the live model's subtrees under the same names)."""
    live_params = dict(live.named_parameters())
    for name, t in target.named_parameters():
        tau = taus[name]
        t.mul_(1.0 - tau).add_(live_params[name], alpha=tau)


def global_grad_norm(grads: Iterable[Optional[torch.Tensor]]) -> torch.Tensor:
    grads = [g for g in grads if g is not None]
    if not grads:
        return torch.zeros(())
    return torch.sqrt(sum(g.float().pow(2).sum() for g in grads))


def grads_of(loss: torch.Tensor, params: List[torch.Tensor]) -> List[Optional[torch.Tensor]]:
    """d loss / d params, None where a parameter does not reach the loss."""
    return list(torch.autograd.grad(loss, params, allow_unused=True))
