"""What decides ``correct`` in training: the program's first rounds of the
window's own call against the reference's steps.

A round is one call of the window (``update_parameters_scan`` of its
``n`` updates); the check takes at least two, since the update programs
run a program's first round eagerly, one step after another, and replay
its captured graph from the second.  Numbers of the first three steps
(read inside the first round where a round is several updates):

- ``loss_gap``: the largest relative gap between the program's and the
  reference's loss over the three steps (the critic's, and the actor's
  where the actor stepped); ``loss1_gap`` the same over the first step;
- ``grad_gap``: per leaf, the gap between the norm of the first step's
  gradient as the program's optimizer got it (Adam's first moment after
  one step over ``1 - beta1``) and the reference's, over the larger of the
  reference leaf's norm and the median leaf's; the largest;
- ``change_gap``: the same for the norm of each leaf's change over the
  three steps, live and target leaves, leaving out the leaves whose
  reference gradient is under a thousandth of the median leaf's (they
  move by round-off alone under Adam);
- ``*_med_gap``: the median leaf's gap instead of the worst, over all
  leaves or over the heads' (``visual.`` left out).

Numbers of all the rounds, the captured program's with them:
``round_loss_gap`` (each round's losses, summed over its steps as the
program's metric vector sums them), ``round_change_gap`` (each leaf's
change over all the steps) and ``moment_gap`` (each leaf's first moment
after them), worst leaf as above.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

GRAD_FLOOR = 1e-3  # leaves under this share of the median leaf's gradient are left out of the change


def program_grad1(agent) -> Dict[str, float]:
    """Each leaf's first moment over ``1 - beta1``, as a norm, from the
    optimizers' state (after one step: the step's gradient)."""
    out = {}
    for tx in (agent.critic_tx, agent.actor_tx, agent.alpha_tx):
        if tx.opt is None:
            continue
        beta1 = tx.opt.param_groups[0]["betas"][0]
        for name, p in zip(tx.names, tx.params):
            st = tx.opt.state.get(p)
            if st and "exp_avg" in st:
                out[name] = float((st["exp_avg"].double() / (1.0 - beta1)).norm())
    return out


def program_params(agent) -> Dict[str, "torch.Tensor"]:  # noqa: F821
    """Every trained leaf as a detached copy: live, ``target.``, ``log_alpha``."""
    out = {n: p.detach().clone() for n, p in agent.model.named_parameters()}
    out.update({f"target.{n}": p.detach().clone() for n, p in agent.target.named_parameters()})
    out["log_alpha"] = agent.log_alpha.detach().clone()
    return out


def param_change(now, before) -> Dict[str, float]:
    return {k: float((now[k].double() - before[k].double()).norm()) for k in before}


def program_change(agent, before) -> Dict[str, float]:
    return param_change(program_params(agent), before)


def program_losses(agent, vec) -> Dict[str, float]:
    """The losses of one step, or of one round summed over its steps, from its metric vector."""
    m = dict(zip(agent._metric_keys, vec.double().cpu().tolist()))
    p = agent.metric_prefix
    out = {"critic_loss": m[f"{p}/critic_loss"], "q": m[f"{p}/q"], "q_target": m[f"{p}/q_target"]}
    if m.get(f"{p}/actor_updated", 0.0) > 0.5:
        out.update(actor_loss=m[f"{p}/actor_loss"], alpha_loss=m[f"{p}/alpha_loss"])
    return out


def _worst_leaf(got: Dict[str, float], want: Dict[str, float], keys) -> tuple:
    keys = list(keys)
    if not keys:
        return 1.0, None
    med = float(np.median([want[k] for k in keys]))
    worst, at = 0.0, None
    for k in keys:
        denom = max(want[k], med, 1e-30)
        gap = abs(got.get(k, 0.0) - want[k]) / denom
        if not math.isfinite(gap):
            gap = math.inf
        if gap > worst or at is None:
            worst, at = gap, k
    return worst, at


def _median_leaf(got: Dict[str, float], want: Dict[str, float], keys) -> float:
    keys = list(keys)
    if not keys:
        return 1.0
    med = float(np.median([want[k] for k in keys]))
    gaps = [abs(got.get(k, 0.0) - want[k]) / max(want[k], med, 1e-30) for k in keys]
    return float(np.median(gaps))


def _loss_gaps(got: List[dict], want: List[dict], what: str) -> tuple:
    """The largest relative gap of the critic's and the actor's losses over
    ``got`` against ``want`` (steps or rounds), where it lies, and the first's."""
    worst, at, first = 0.0, None, 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        for key in ("critic_loss", "actor_loss"):
            if key in w:
                gap = abs(g.get(key, math.nan) - w[key]) / max(abs(w[key]), 1e-12)
                gap = gap if math.isfinite(gap) else math.inf
                if i == 0:
                    first = max(first, gap)
                if gap > worst or at is None:
                    worst, at = gap, f"{what} {i + 1} {key}"
    if len(got) != len(want):
        worst = first = math.inf
    return worst, at, first


def compare(got: dict, want: dict, yard: dict = None) -> Dict[str, dict]:
    """The training numbers of ``got`` (the program's readings, or a
    control's) against ``want`` (the reference's).  With ``yard`` (the
    reference's first steps in the configuration's own precision, where
    that is below float32), also ``grad_med_ratio``: the median leaf's
    first-gradient gap over the yardstick's, how far the program strays
    from float32 in units of how far plain rounding to the configuration's
    precision strays on the same weights, rows and draws.  Seed to seed the
    bare gaps swing with how many max-pool winners flip and how many near-
    zero gradients Adam's first steps move, for the program and a lower
    precision alike; the ratio takes that out."""
    out = _compare(got, want)
    if yard is not None:
        base = _compare(yard, want)["grad_med_gap"]["value"]
        out["grad_med_ratio"] = {"value": out["grad_med_gap"]["value"] / max(base, 1e-12),
                                 "at": f"grad_med_gap over the yardstick's {base:.3g}"}
    return out


def _compare(got: dict, want: dict) -> Dict[str, dict]:
    loss_gap, loss_at, first = _loss_gaps(got["losses"], want["losses"], "step")
    round_gap, round_at, _ = _loss_gaps(got["round_losses"], want["round_losses"], "round")
    q1 = 0.0
    if got["losses"] and want["losses"]:
        for key in ("q", "q_target"):
            w = want["losses"][0][key]
            q1 = max(q1, abs(got["losses"][0].get(key, math.nan) - w) / max(abs(w), 1e-12))
        q1 = q1 if math.isfinite(q1) else math.inf
    grad_gap, grad_at = _worst_leaf(got["grad1"], want["grad1"], want["grad1"])
    heads = [k for k in want["grad1"] if not k.startswith("visual.")]
    grad_heads, grad_heads_at = _worst_leaf(got["grad1"], want["grad1"], heads)
    g = want["grad1"]
    med_g = float(np.median(list(g.values()))) if g else 0.0
    kept = [k for k in want["change"] if g.get(k.removeprefix("target."), 0.0) >= GRAD_FLOOR * med_g]
    change_gap, change_at = _worst_leaf(got["change"], want["change"], kept)
    round_change, round_change_at = _worst_leaf(got["round_change"], want["round_change"], kept)
    moment_gap, moment_at = _worst_leaf(got["moments"], want["moments"], want["moments"])
    return {"loss_gap": {"value": loss_gap, "at": loss_at},
            "loss1_gap": {"value": first, "at": "step 1"},
            "q1_gap": {"value": q1, "at": "step 1 mean q and q target"},
            "round_loss_gap": {"value": round_gap, "at": round_at},
            "round_change_gap": {"value": round_change, "at": round_change_at},
            "moment_gap": {"value": moment_gap, "at": moment_at},
            "grad_heads_gap": {"value": grad_heads, "at": grad_heads_at},
            "grad_med_gap": {"value": _median_leaf(got["grad1"], want["grad1"], want["grad1"]), "at": "median leaf"},
            "change_med_gap": {"value": _median_leaf(got["change"], want["change"], kept), "at": "median leaf"},
            "grad_heads_med_gap": {"value": _median_leaf(got["grad1"], want["grad1"], heads),
                                   "at": "median leaf of the heads"},
            "change_heads_med_gap": {"value": _median_leaf(got["change"], want["change"],
                                                           [k for k in kept if not k.startswith("visual.")]),
                                     "at": "median leaf of the heads"},
            "grad_gap": {"value": grad_gap, "at": grad_at},
            "change_gap": {"value": change_gap, "at": change_at,
                           "left_out": sorted(set(want["change"]) - set(kept))}}


# ------------------------------------------------------- the ManiSkill fill
def seg_budget(num_pts, n_points: int, min_pts: int, fg_pts: int) -> List[int]:
    """Points per segment and for the background of the seg-balanced
    downsample, for segment counts ``num_pts`` (the counts are large enough
    that no tiling happens)."""
    num_pts = np.asarray(num_pts)
    base = np.minimum(num_pts, min_pts)
    remain = num_pts - base
    tgt = base + (fg_pts - base.sum()) * remain // max(int(remain.sum()), 1)
    return [int(v) for v in tgt] + [int(n_points - tgt.sum())]
