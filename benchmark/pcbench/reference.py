"""Plain PyTorch reference of the SAC / DrQ update of a visual actor-critic.

The benchmark holds the port's timed updates against this module.  It
imports nothing of the port: it is written from the algorithm's equations
(SAC with twin Q heads, a shared visual backbone trained by the critic,
interval-gated actor, alpha and target steps; DrQ's K augmented copies)
and works on a plain dict of named tensors.  Parameter names follow the
configuration's layout (``visual.*``, ``actor.final_mlp.*``,
``critic.VmapMLP_0.*``), so a reading can be set beside the program's leaf
by leaf.  The backbone is the encoder the configuration names
(``reference.encoder``: the module ``encoders/<name>.py``).

Every matrix product goes through ``matmul`` in one of four precisions:

- ``"float32"``: IEEE f32 products (TF32 is switched off by ``precise()``);
- ``"bfloat16"``: both operands rounded to bfloat16, f32 sums: a bfloat16
  configuration's own rounding, the yardstick of its readings;
- ``"tf32"``: both operands rounded to TF32's 10-bit mantissa, f32 sums;
- ``"float8"``: both operands scaled per tensor and rounded to float8
  e4m3, f32 sums.

The forward and the backward products alike.  ``float32`` is the reference;
the last two are the controls that must come out not correct (TF32 under a
float32 configuration, float8 under a bfloat16 one).

Randomness: the update draws what the configuration's algorithm draws, in
its order, from generators the caller seeds: the batch indices (64 random
bits modulo the buffer size), DrQ's translations (uniform per row and
axis) and the policy's noise (standard normal per row and action).
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence

import torch

from . import encoders

PRECISIONS = ("float32", "bfloat16", "tf32", "float8")
_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)
_F8_MAX = 448.0  # the largest float8 e4m3 value


@contextmanager
def precise():
    """f32 products in IEEE f32 (no TF32) inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def round_operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` (f32) as a product's operand in ``precision``, back in f32."""
    if precision == "float32":
        return x
    if precision == "bfloat16":
        return x.to(torch.bfloat16).float()
    if precision == "tf32":  # round to nearest (ties away) at 10 mantissa bits
        bits = x.contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF
        return bits.view(torch.float32)
    if precision == "float8":
        amax = x.detach().abs().amax().clamp_min(1e-30)
        scale = _F8_MAX / amax
        return (x * scale).to(torch.float8_e4m3fn).float() / scale
    raise ValueError(f"unknown precision {precision!r}; expected one of {PRECISIONS}")


class _RoundedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, precision):
        qa, qb = round_operand(a, precision), round_operand(b, precision)
        ctx.save_for_backward(qa, qb)
        ctx.precision = precision
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = round_operand(g.contiguous(), ctx.precision)
        ga = qg @ qb.transpose(-1, -2) if ctx.needs_input_grad[0] else None
        gb = qa.transpose(-1, -2) @ qg if ctx.needs_input_grad[1] else None
        if gb is not None and gb.dim() > qb.dim():  # an operand broadcast over leading axes
            gb = gb.sum(dim=tuple(range(gb.dim() - qb.dim())))
        return ga, gb, None


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    if precision == "float32":
        return a @ b
    return _RoundedMatmul.apply(a, b, precision)


# ------------------------------------------------------------------ the nets
def linear(x, w, b, precision):
    """``x @ w.T + b`` for a ``[out, in]`` weight."""
    return matmul(x, w.t(), precision) + b


def mlp(P, prefix: str, x, n_layers: int, precision: str, head: Optional[int] = None):
    """ReLU MLP without norms, the last layer linear; ``head`` picks one of
    a stacked ensemble's ``[heads, in, out]`` kernels."""
    for i in range(n_layers):
        w, b = P[f"{prefix}Dense_{i}.weight"], P[f"{prefix}Dense_{i}.bias"]
        if head is None:
            x = linear(x, w, b, precision)
        else:
            x = matmul(x, w[head], precision) + b[head]
        if i < n_layers - 1:
            x = torch.relu(x)
    return x


def critic(P, prefix: str, x, n_layers: int, heads: int, precision: str) -> torch.Tensor:
    """``[R, heads]`` Q-values of the stacked critic over ``x``."""
    return torch.cat([mlp(P, prefix, x, n_layers, precision, head=h) for h in range(heads)], dim=-1)


def tanh_gaussian(out: torch.Tensor, noise: torch.Tensor, log_std_bound):
    """(action, -log p) of the squashed Gaussian (unit action box)."""
    mean, log_std = out.chunk(2, dim=-1)
    std = log_std.clamp(log_std_bound[0], log_std_bound[1]).exp()
    z = mean + std * noise
    log_p = (-((z - mean) ** 2) / (2 * std * std) - torch.log(std) - _LOG_SQRT_2PI
             - torch.log(1.0 - torch.tanh(z) ** 2 + 1e-6)).sum(-1)
    return torch.tanh(z), -log_p[..., None]


# ------------------------------------------------------------------ the update
class Spec:
    """What the update needs of a configuration (a dict from its file)."""

    def __init__(self, d: dict):
        self.algo = d["algo"]  # "SAC" or "DrQ"
        self.batch_size = int(d["batch_size"])
        self.num_aug = int(d.get("num_aug", 1))
        self.gamma = float(d["gamma"])
        self.alpha = float(d["alpha"])
        self.action_dim = int(d["action_dim"])
        self.target_entropy = -float(self.action_dim)
        self.actor_interval = int(d["actor_update_interval"])
        self.target_interval = int(d["target_update_interval"])
        self.tau = float(d["target_tau"])
        self.actor_layers = int(d["actor_layers"])
        self.critic_layers = int(d["critic_layers"])
        self.critic_heads = int(d["critic_heads"])
        self.log_std_bound = tuple(float(v) for v in d["log_std_bound"])
        self.lr = {k: float(v) for k, v in d["lr"].items()}
        self.betas = {k: tuple(float(b) for b in v) for k, v in d["betas"].items()}
        self.translation = d.get("translation")  # DrQ's shift per axis, or None
        self.encoder = encoders.load(d["encoder"])  # the backbone's module: encode, FLOPs, seeding


def init_state(weights: Dict[str, torch.Tensor], spec: Spec) -> dict:
    """Train state from ``weights`` (the live nets' leaves): the target
    critic as a copy, log alpha from the configuration, empty Adam state."""
    P = {k: v.detach().clone().float() for k, v in weights.items()}
    P["log_alpha"] = torch.tensor(math.log(spec.alpha), dtype=torch.float32, device=next(iter(P.values())).device)
    T = {k: P[k].clone() for k in P if k.startswith("critic.")}
    groups = {"critic": sorted(k for k in P if k.startswith(("visual.", "critic."))),
              "actor": sorted(k for k in P if k.startswith("actor.")),
              "alpha": ["log_alpha"]}
    adam = {g: {"t": 0, "m": {k: torch.zeros_like(P[k]) for k in ks}, "v": {k: torch.zeros_like(P[k]) for k in ks}}
            for g, ks in groups.items()}
    return {"P": P, "T": T, "groups": groups, "adam": adam, "updates": 0}


def adam_step(state: dict, group: str, grads: Dict[str, torch.Tensor], spec: Spec) -> None:
    opt = state["adam"][group]
    opt["t"] += 1
    t = opt["t"]
    b1, b2 = spec.betas[group]
    lr = spec.lr[group]
    with torch.no_grad():
        for k in state["groups"][group]:
            g = grads[k]
            m = opt["m"][k].mul_(b1).add_(g, alpha=1 - b1)
            v = opt["v"][k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v / (1 - b2 ** t)).sqrt() + 1e-8
            state["P"][k] -= lr * (m / (1 - b1 ** t)) / denom


def _with_state(feat, obs):
    return torch.cat([feat, obs["state"].float()], dim=-1) if "state" in obs else feat


def _rows(obs: dict, idx) -> dict:
    return {k: v[idx] for k, v in obs.items()}


def _repeat(obs: dict, k: int) -> dict:
    return {key: v.repeat_interleave(k, dim=0) for key, v in obs.items()}


def _shift(obs: dict, gen, spec: Spec) -> dict:
    """DrQ's translation of each row's xyz channels (the first three)."""
    pcd = obs["pcd"]
    rows = pcd.shape[0]
    u = torch.rand((rows, 3), generator=gen, device=pcd.device)
    delta = (u - 0.5) * 2.0 * torch.tensor(spec.translation, dtype=torch.float32, device=pcd.device)
    xyz = pcd[..., :3].float() + delta[:, None, :]
    out = dict(obs)
    out["pcd"] = torch.cat([xyz, pcd[..., 3:].float()], dim=-1)
    return out


def _normal(gen, rows: int, spec: Spec, device) -> torch.Tensor:
    return torch.randn((rows, spec.action_dim), generator=gen, device=device, dtype=torch.float32)


def update(state: dict, batch: dict, gen: torch.Generator, spec: Spec, precision: str = "float32",
           fault: Optional[str] = None) -> Dict[str, float]:
    """One gradient step on ``batch`` (obs and next_obs as ``{"pcd": [B, N, C],
    "state"?: [B, S]}``, actions ``[B, A]``, rewards and dones ``[B, 1]``),
    drawing from ``gen``.  Returns the step's losses.

    ``fault="half_batch"`` takes every loss over the first half of the rows
    only: a planted fault (``run_steps`` also plants ``"unchanged"``: each
    step computes its losses and leaves the state as it was)."""
    P, T = state["P"], state["T"]
    K = spec.num_aug if spec.algo == "DrQ" else 1
    L, H = spec.critic_layers, spec.critic_heads
    if fault == "half_batch":
        half = batch["rewards"].shape[0] // 2
        batch = {k: (_rows(v, slice(0, half)) if isinstance(v, dict) else v[:half]) for k, v in batch.items()}
    B = batch["rewards"].shape[0]
    obs, next_obs = batch["obs"], batch["next_obs"]
    actions, rewards, dones = batch["actions"].float(), batch["rewards"].float(), batch["dones"].float()
    if spec.algo == "DrQ":
        obs = _shift(_repeat(obs, K), gen, spec)
        next_obs = _shift(_repeat(next_obs, K), gen, spec)
        actions, rewards, dones = (x.repeat_interleave(K, dim=0) for x in (actions, rewards, dones))
        reward_scale = 1.0
    else:
        reward_scale = 1.0
    alpha = P["log_alpha"].exp()

    # the bootstrap target, from the pre-step parameters
    with torch.no_grad():
        feat_next = spec.encoder.encode(P, next_obs["pcd"], precision)
        out = mlp(P, "actor.final_mlp.", _with_state(feat_next, next_obs), spec.actor_layers, precision)
        a_next, neg_logp = tanh_gaussian(out, _normal(gen, B * K, spec, out.device), spec.log_std_bound)
        q_next = critic(T, "critic.VmapMLP_0.", torch.cat([_with_state(feat_next, next_obs), a_next], -1), L, H,
                        precision)
        q_target = rewards * reward_scale + (1.0 - dones) * spec.gamma * (q_next.min(-1, keepdim=True).values
                                                                           + alpha * neg_logp)
        if K > 1:
            q_target = q_target.reshape(B, K).mean(dim=1, keepdim=True).repeat_interleave(K, dim=0)

    # the critic step, through the shared encoder
    keys = state["groups"]["critic"]
    leaves = {k: P[k].detach().requires_grad_(True) for k in keys}
    Pc = dict(P, **leaves)
    feat = spec.encoder.encode(Pc, obs["pcd"], precision)
    q = critic(Pc, "critic.VmapMLP_0.", torch.cat([_with_state(feat, obs), actions], -1), L, H, precision)
    critic_loss = ((q - q_target) ** 2).mean() * H
    grads = dict(zip(keys, torch.autograd.grad(critic_loss, [leaves[k] for k in keys])))
    adam_step(state, "critic", grads, spec)
    losses = {"critic_loss": float(critic_loss.detach()), "q": float(q.detach().min(-1).values.mean()),
              "q_target": float(q_target.mean())}

    if state["updates"] % spec.actor_interval == 0:
        # the actor step on copy 0 of each row, reusing the critic forward's
        # (pre-step) feature, then the alpha step
        saved = feat.detach()[::K]
        a_obs = _rows(obs, slice(None, None, K))
        x = _with_state(saved, a_obs)
        keys = state["groups"]["actor"]
        leaves = {k: P[k].detach().requires_grad_(True) for k in keys}
        Pa = dict(P, **leaves)
        a_alpha = P["log_alpha"].detach().exp()
        out = mlp(Pa, "actor.final_mlp.", x, spec.actor_layers, precision)
        pi, neg_logp = tanh_gaussian(out, _normal(gen, B, spec, out.device), spec.log_std_bound)
        entropy = neg_logp.mean()
        q_pi = critic(P, "critic.VmapMLP_0.", torch.cat([x, pi], -1), L, H, precision).min(-1).values.mean()
        actor_loss = -(q_pi + a_alpha * entropy)
        a_grads = dict(zip(keys, torch.autograd.grad(actor_loss, [leaves[k] for k in keys])))
        adam_step(state, "actor", a_grads, spec)
        log_alpha = P["log_alpha"].detach().requires_grad_(True)
        alpha_loss = log_alpha.exp() * (entropy.detach() - spec.target_entropy)
        (g_alpha,) = torch.autograd.grad(alpha_loss, [log_alpha])
        adam_step(state, "alpha", {"log_alpha": g_alpha}, spec)
        losses.update(actor_loss=float(actor_loss.detach()), alpha_loss=float(alpha_loss.detach()))

    if state["updates"] % spec.target_interval == 0:
        with torch.no_grad():
            for k in T:
                T[k].mul_(1.0 - spec.tau).add_(P[k], alpha=spec.tau)
    state["updates"] += 1
    return losses


def change_norms(after: dict, before: dict) -> Dict[str, float]:
    """``|after - before|`` per leaf, live (``k``) and target (``target.k``)."""
    out = {k: float((after["P"][k].double() - before["P"][k].double()).norm()) for k in after["P"]}
    out.update({f"target.{k}": float((after["T"][k].double() - before["T"][k].double()).norm())
                for k in after["T"]})
    return out


def clone_state(state: dict) -> dict:
    return {"P": {k: v.clone() for k, v in state["P"].items()}, "T": {k: v.clone() for k, v in state["T"].items()}}


def _round_losses(steps: List[Dict[str, float]]) -> Dict[str, float]:
    """A round's losses summed over its steps, as the program's metric
    vector sums them (the actor's over the steps where the actor stepped)."""
    out: Dict[str, float] = {}
    for losses in steps:
        for k, v in losses.items():
            out[k] = out.get(k, 0.0) + v
    return out


def first_moments(state: dict, spec: Spec) -> Dict[str, float]:
    """Each leaf's Adam first moment over ``1 - beta1``, as a norm: the
    step's gradient after one step, a decaying sum of the gradients after
    more."""
    out = {}
    for group, opt in state["adam"].items():
        b1 = spec.betas[group][0]
        out.update({k: float((m.double() / (1.0 - b1)).norm()) for k, m in opt["m"].items()})
    return out


def run_steps(weights: Dict[str, torch.Tensor], batches: Sequence[Callable[[], dict]], gen: torch.Generator,
              spec: Spec, precision: str = "float32", fault: Optional[str] = None, per_round: int = 1,
              observed: int = 3) -> dict:
    """``len(batches)`` updates from ``weights``; ``batches[i]()`` gives step
    i's batch (called when the step runs, so it may draw from the same
    generator streams as the program's sampler).  ``per_round`` updates make
    a round, the program's call.  Returns the readings the check compares:
    the losses of each of the first ``observed`` steps, each leaf's gradient
    at the first step (``grad1``) and its change over the first ``observed``
    steps; each round's losses (summed over its steps), each leaf's change
    over all the steps and its first moment after them (``moments``).

    Planted faults (the readings' own): ``half_batch`` (see ``update``);
    ``unchanged``, each step computes its losses and leaves the state as it
    was; ``one_draw``, every step of a round takes the round's first batch."""
    with precise():
        state = init_state(weights, spec)
        start = clone_state(state)
        steps: List[Dict[str, float]] = []
        first, early = None, None
        batch = None
        for i, make in enumerate(batches):
            if fault != "one_draw" or i % per_round == 0:
                batch = make()
            if fault == "unchanged":
                trial = dict(state, P=dict(clone_state(state)["P"]), T=clone_state(state)["T"],
                             adam={g: {"t": o["t"], "m": {k: v.clone() for k, v in o["m"].items()},
                                       "v": {k: v.clone() for k, v in o["v"].items()}}
                                   for g, o in state["adam"].items()})
                steps.append(update(trial, batch, gen, spec, precision))
            else:
                steps.append(update(state, batch, gen, spec, precision, fault=fault))
            if i == 0:
                first = first_moments(state, spec)
            if i == observed - 1:
                early = change_norms(state, start)
        change = change_norms(state, start)
        moments = first_moments(state, spec)
    losses = [_round_losses(steps[i:i + per_round]) for i in range(0, len(steps), per_round)]
    return {"losses": steps[:observed], "grad1": first or {}, "change": early or change, "round_losses": losses,
            "round_change": change, "moments": moments, "state": state}
