"""Optimizers with per-parameter regex config, and the per-path EMA.

Port of ``pointcloud_rl_tpu/algorithms/optim.py`` (Adam, AdamW, SGD,
RMSprop, each stepping as its optax counterpart; ``max_grad_norm``
clipping).  On CUDA parameters Adam and AdamW are ``capturable``: their
step count lives on the device, so the eager step and the step inside a
captured CUDA graph (``algorithms/graphs.py``) do the same arithmetic; CPU
parameters keep the default, which the JAX comparisons hold.  Every
optimizer updates its state in place, as a graph replay needs.
``optim_cfg`` dicts like
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
from ..parallel.mesh import DataParallel

NamedParams = Sequence[Tuple[str, torch.Tensor]]


def _first_match(patterns: Dict[str, object], path: str):
    for pat, val in patterns.items():
        if re.search(pat, path):
            return True, val
    return False, None


class OptaxRMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(lr, decay=0.9, eps, momentum)``, which
    ``torch.optim.RMSprop`` is not: optax divides by ``sqrt(nu + eps)``
    (eps inside the root) and starts ``nu`` at 0 with decay 0.9.  Then
    ``optax.trace(momentum)`` over the scaled gradients, then ``-lr``."""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8, momentum: float = 0.0):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps, momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            decay, eps, momentum = group["decay"], group["eps"], group["momentum"]
            for p in group["params"]:
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                    if momentum:
                        state["trace"] = torch.zeros_like(p)
                g, nu = p.grad, state["nu"]
                nu.copy_((1 - decay) * g.square() + decay * nu)
                u = g * torch.rsqrt(nu + eps)
                if momentum:
                    trace = state["trace"]
                    trace.copy_(u + momentum * trace)
                    u = trace
                p.add_(u * -group["lr"])


def _torch_optimizer(kind: str, params: List[torch.Tensor], lr: float, betas, eps: float, weight_decay: float,
                     cfg: dict) -> torch.optim.Optimizer:
    """The branch of the JAX ``make_optimizer`` that ``kind`` names.
    ``Adam`` with ``weight_decay`` is ``optax.adamw``: the decay multiplies
    the pre-step parameter, as ``torch.optim.AdamW`` does."""
    kind = kind.lower()
    if kind in ("adam", "adamw"):
        capturable = params[0].is_cuda
        if kind == "adamw" or weight_decay:
            opt = torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                                    capturable=capturable)
        else:  # torch Adam's step is optax.adam's: lr * m_hat / (sqrt(v_hat) + eps)
            opt = torch.optim.Adam(params, lr=lr, betas=betas, eps=eps, capturable=capturable)
        # torch warns when a capturable step runs eagerly; here that is the
        # point: the eager step does the arithmetic of the graphed one
        opt._warned_capturable_if_run_uncaptured = True
        return opt
    if kind == "sgd":
        # optax.trace starts at 0, so its first step is g, as torch's buffer
        return torch.optim.SGD(params, lr=lr, momentum=cfg.pop("momentum", 0.0),
                               nesterov=cfg.pop("nesterov", False))
    if kind == "rmsprop":
        return OptaxRMSprop(params, lr=lr, eps=eps, momentum=cfg.pop("momentum", 0.0))
    raise KeyError(f"Unknown optimizer type {kind}")


class Optimizer:
    """The optimizer a config names (Adam, AdamW, SGD, RMSprop, each as its
    optax counterpart), over the parameters the config trains, with
    optional global-norm clipping (``max_grad_norm``) of their gradients
    before the step.  A data-parallel rank (``data_parallel``, set by
    ``parallel.setup_data_parallel``) all-reduces the gradients first, so
    the clip sees the global gradient, as optax does."""

    data_parallel = DataParallel()  # a world of one: the all-reduce is the identity

    def __init__(self, optim_cfg: Optional[dict], named_params: NamedParams):
        cfg = dict(optim_cfg or {"type": "Adam", "lr": 3e-4})
        kind = cfg.pop("type", "Adam")
        lr = cfg.pop("lr", 3e-4)
        betas = tuple(cfg.pop("betas", (0.9, 0.999)))
        eps = cfg.pop("eps", 1e-8)
        weight_decay = cfg.pop("weight_decay", 0.0)
        param_cfg = cfg.pop("param_cfg", None) or {}
        self.max_grad_norm = cfg.pop("max_grad_norm", None)
        self.names: List[str] = []
        self.params: List[torch.Tensor] = []
        for name, p in named_params:
            matched, val = _first_match(param_cfg, regex_path(name))
            if matched and val is None:
                continue
            self.names.append(name)
            self.params.append(p)
        self.opt = (_torch_optimizer(kind, self.params, lr, betas, eps, weight_decay, cfg)
                    if self.params else None)
        if cfg:
            raise NotImplementedError(f"optimizer {kind!r}: options {sorted(cfg)} are not ported to "
                                      "pointcloud_rl_torch")

    def step(self, grads: Sequence[Optional[torch.Tensor]],
             extra: Sequence[Optional[torch.Tensor]] = ()) -> Tuple[List[torch.Tensor], List[Optional[torch.Tensor]]]:
        """One step with ``grads`` aligned to ``self.params`` (None = zero,
        as a leaf without a gradient gets a zero update from optax).
        ``extra``: gradients of leaves this optimizer does not train, which a
        grad norm still counts; a data-parallel rank reduces them in the same
        all-reduce.  Returns (the gradients stepped with, before the clip;
        ``extra``), both averaged over the ranks."""
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        extra = list(extra)
        present = [i for i, g in enumerate(extra) if g is not None]
        reduced = self.data_parallel.allreduce_grads(grads + [extra[i] for i in present])
        grads = reduced[:len(grads)]
        for i, g in zip(present, reduced[len(grads):]):
            extra[i] = g
        if self.opt is None:
            return grads, extra
        stepped = grads
        if self.max_grad_norm is not None:
            # optax.clip_by_global_norm: g / |g| * max_norm unless |g| < max_norm
            g_norm = global_grad_norm(grads)
            keep = g_norm < self.max_grad_norm
            grads = [torch.where(keep, g, g / g_norm * self.max_grad_norm) for g in grads]
        for p, g in zip(self.params, grads):
            p.grad = g
        self.opt.step()
        for p in self.params:
            p.grad = None
        return stepped, extra

    def state_dict(self):
        return self.opt.state_dict() if self.opt is not None else {}

    def load_state_dict(self, state) -> None:
        """Load ``state_dict()``'s output.  The optimizer keeps its own
        ``capturable`` flag: torch would take the saved one, so a state saved
        on the CPU would turn it off on the card (and the update programs'
        capture would fail); with the flag the step count goes to the card."""
        if self.opt is not None:
            groups = [dict(saved, **{k: own[k] for k in ("capturable",) if k in own})
                      for saved, own in zip(state["param_groups"], self.opt.param_groups)]
            self.opt.load_state_dict(dict(state, param_groups=groups))


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


def global_grad_norm(grads: Iterable[Optional[torch.Tensor]], device=None) -> torch.Tensor:
    """The L2 norm over all ``grads`` (None entries skipped), f32; zero on
    ``device`` when there is none."""
    grads = [g for g in grads if g is not None]
    if not grads:
        return torch.zeros((), device=device)
    return torch.sqrt(sum(g.float().pow(2).sum() for g in grads))


def grads_of(loss: torch.Tensor, params: List[torch.Tensor]) -> List[Optional[torch.Tensor]]:
    """d loss / d params, None where a parameter does not reach the loss."""
    return list(torch.autograd.grad(loss, params, allow_unused=True))
