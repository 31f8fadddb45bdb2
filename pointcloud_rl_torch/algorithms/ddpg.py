"""DDPG / TD3 (port of ``pointcloud_rl_tpu/algorithms/ddpg.py``).

A deterministic actor (the head's "eval" mode) with Gaussian exploration
noise clipped to the action bounds, twin-Q critics (``num_heads=1`` is
classic DDPG), a target policy network (the ``actor`` subtree added to
the target and to its EMA rates), optional TD3 target-policy smoothing
(``use_target_smoothing``) and the actor/target intervals of SAC, whose
update plumbing it reuses.  The actor loss is the deterministic policy
gradient on the FIRST Q head.  The alpha of SAC stays unused (1e-8, not
tuned).  The noise is drawn from the agent's generator through
``standard_normal`` in this module's namespace, which tests may patch.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

from ..models.distributions import standard_normal  # noqa: F401  (the draw tests may patch)
from . import MFRL
from .optim import build_tau_tree, global_grad_norm
from .sac import SAC


@MFRL.register_module()
class DDPG(SAC):
    def __init__(self, *args, exploration_noise: float = 0.1, target_noise: float = 0.2,
                 target_noise_clip: float = 0.5, use_target_smoothing: bool = True, **kwargs):
        kwargs.setdefault("metric_prefix", "ddpg")
        kwargs.setdefault("automatic_alpha_tuning", False)
        kwargs.setdefault("alpha", 1e-8)  # the entropy term is unused
        self.exploration_noise = float(exploration_noise)
        self.target_noise = float(target_noise)
        self.target_noise_clip = float(target_noise_clip)
        self.use_target_smoothing = bool(use_target_smoothing)
        super().__init__(*args, **kwargs)
        if self.is_discrete:
            raise ValueError("DDPG needs continuous actions")
        if self.model.is_recurrent:
            raise NotImplementedError("a recurrent DDPG: the JAX package's DDPG act does not thread rnn states")
        # the target policy network a' = pi_target(s'), tracked by EMA
        self.target["actor"] = copy.deepcopy(self.model.actor).requires_grad_(False)
        self.taus = build_tau_tree(kwargs.get("update_coeff", 0.005), (n for n, _ in self.target.named_parameters()))

    def _bounds(self):
        head = self.model.actor.head
        return (head.lb, head.ub) if getattr(head, "has_bounds", False) else None

    def act(self, obs, mode: str) -> torch.Tensor:
        if mode not in ("explore", "sample"):
            return super().act(obs, mode)
        out, _ = self.model.actor_apply(obs, mode="eval")
        a = out + self.exploration_noise * standard_normal(out, self.act_generator)
        bounds = self._bounds()
        return a if bounds is None else a.clamp(*bounds)

    def _compute_q_target(self, batch, reward_scale: Optional[float] = None) -> torch.Tensor:
        model = self.model
        next_a, _ = model.target_actor_apply(self.target, batch["next_obs"], mode="eval")
        if self.use_target_smoothing:
            noise = (self.target_noise * standard_normal(next_a, self.generator)).clamp(
                -self.target_noise_clip, self.target_noise_clip)
            bounds = self._bounds()
            next_a = (next_a + noise).clamp(*(bounds if bounds is not None else (-1.0, 1.0)))
        q_next = model.target_critic_apply(self.target, batch["next_obs"], actions=next_a)
        min_q_next = q_next.min(dim=-1, keepdim=True).values
        rewards = batch["rewards"] * (self.reward_scale if reward_scale is None else reward_scale)
        if self.ignore_dones:
            return rewards + self.gamma * min_q_next
        return rewards + (1.0 - batch["dones"].float()) * self.gamma * min_q_next

    def _actor_alpha_step(self, batch, saved_feat, actor_obs=None):
        model = self.model
        obs = batch["obs"] if actor_obs is None else actor_obs
        reuse = saved_feat if (self.shared_backbone and self.detach_actor_feature
                               and self.stale_actor_feature) else None
        pi, feat = model.actor_apply(obs, mode="eval", detach_visual=self.detach_actor_feature, visual_feature=reuse)
        vf = feat.detach() if (self.shared_backbone and feat is not None) else None
        actor_loss = -model.critic_apply(obs, actions=pi, visual_feature=vf)[..., 0].mean()
        grads = self._step(actor_loss, self._actor_named, self.actor_tx, norm_keys={"actor"})
        zero = torch.zeros((), device=self.device)
        return actor_loss, zero, zero, global_grad_norm(grads, self.device), zero
