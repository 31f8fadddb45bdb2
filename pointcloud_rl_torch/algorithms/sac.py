"""Soft Actor-Critic, continuous and non-recurrent.

Port of ``pointcloud_rl_tpu/algorithms/sac.py``: twin-Q targets with the
entropy bonus, MSE critic loss x num_q, interval-gated actor/alpha/target
updates on the agent's own update counter (starting at 0), automatic alpha
tuning, the shared visual backbone trained by the critic with detached
actor features, and per-path regex EMA rates.

One update, in the JAX package's order:
  1. q-target from the PRE-step parameters, without autograd;
  2. critic step (the critic's forward also returns its visual feature);
  3. if ``updates % actor_update_interval == 0``: actor step on the
     post-critic-step parameters (re-encoding the obs, or with
     ``stale_actor_feature`` reusing the critic forward's detached
     feature), then the alpha step;
  4. if ``updates % target_update_interval == 0``: EMA of the target.
Each loss is differentiated with ``torch.autograd.grad`` over exactly the
parameters it may move, so the actor loss never steps the critic or the
shared encoder.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..models import build_actor_critic
from ..models.builder import extract_freeze_param_cfg
from . import MFRL
from .base import BaseAgent, to_torch
from .optim import Optimizer, build_tau_tree, global_grad_norm, grads_of, soft_update

_ACTOR_KEYS = ("actor_loss", "alpha_loss", "entropy", "actor_grad")


@MFRL.register_module()
class SAC(BaseAgent):
    def __init__(
        self,
        actor_cfg,
        critic_cfg,
        env_params,
        batch_size=128,
        gamma=0.99,
        reward_scale=1,
        update_coeff=0.005,
        alpha=0.2,
        alpha_optim_cfg=None,
        automatic_alpha_tuning=True,
        target_entropy=None,
        ignore_dones=False,
        use_episode_dones=False,
        target_update_interval=1,
        actor_update_interval=1,
        shared_backbone=False,
        shared_target_backbone=None,
        detach_actor_feature=False,
        target_smooth=0.90,
        pre_process=None,
        obs_rms: bool = False,
        seed: int = 0,
        metric_prefix: str = "sac",
        bf16: bool = False,
        stale_actor_feature: bool = False,
        obs_transfer_cfg: Optional[dict] = None,
        device="cpu",
    ):
        super().__init__(device)
        if pre_process is not None:
            raise NotImplementedError("pre_process augmentations are not ported to pointcloud_rl_torch "
                                      "yet (ROADMAP.md queue A, item A2)")
        if obs_transfer_cfg is not None:
            raise NotImplementedError("obs_transfer_cfg is not ported to pointcloud_rl_torch yet "
                                      "(ROADMAP.md queue A, item A1)")
        if obs_rms:
            raise NotImplementedError("obs_rms (flat state observations) is not ported to "
                                      "pointcloud_rl_torch yet (ROADMAP.md queue A, item A4)")
        self.batch_size = batch_size
        self.gamma = float(gamma)
        self.reward_scale = float(reward_scale)
        self.ignore_dones = bool(ignore_dones)
        self.use_episode_dones = bool(use_episode_dones)
        self.target_update_interval = int(target_update_interval)
        self.actor_update_interval = int(actor_update_interval)
        self.automatic_alpha_tuning = bool(automatic_alpha_tuning)
        self.shared_backbone = bool(shared_backbone)
        self.detach_actor_feature = bool(detach_actor_feature)
        # True: the actor reuses the critic forward's (pre-critic-step)
        # visual feature instead of re-encoding (see the JAX package).
        self.stale_actor_feature = bool(stale_actor_feature)
        self.metric_prefix = metric_prefix

        actor_cfg, critic_cfg = dict(actor_cfg), dict(critic_cfg)
        actor_optim_cfg = actor_cfg.pop("optim_cfg", None)
        critic_optim_cfg = critic_cfg.pop("optim_cfg", None)
        freeze_cfg = extract_freeze_param_cfg(actor_cfg.get("nn_cfg"))
        if freeze_cfg:
            actor_optim_cfg = dict(actor_optim_cfg or {"type": "Adam", "lr": 3e-4})
            critic_optim_cfg = dict(critic_optim_cfg or {"type": "Adam", "lr": 3e-4})
            for ocfg in (actor_optim_cfg, critic_optim_cfg):
                pc = dict(ocfg.get("param_cfg") or {})
                pc.update(freeze_cfg)
                ocfg["param_cfg"] = pc

        # Weights come from a CPU generator seeded with ``seed``, so a model
        # is the same on every device; sampling noise from one on the device.
        init_gen = torch.Generator().manual_seed(int(seed))
        model = build_actor_critic(actor_cfg, critic_cfg, env_params, shared_backbone=self.shared_backbone,
                                   shared_target_backbone=shared_target_backbone, bf16=bf16,
                                   generator=init_gen)
        self.model = model.to(self.device)
        self.target = self.model.make_target()
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))
        self.modules = {"model": self.model, "target": self.target}

        action_shape = env_params["action_shape"]
        self.target_entropy = (-float(np.prod(action_shape)) if target_entropy is None
                               else float(target_entropy))
        init_log_alpha = float(np.log(np.float32(alpha)))
        self.log_alpha = torch.nn.Parameter(torch.tensor(init_log_alpha, device=self.device))
        self.updates = 0  # gradient steps taken: gates the actor and target updates

        # Gradients each loss takes (the JAX package's grad-norm masks), and
        # the subset each optimizer steps (those minus param_cfg exclusions).
        def named(keys):
            return [(n, p) for n, p in self.model.named_parameters() if n.split(".")[0] in keys]

        critic_keys = {"critic", "critic_visual"} | ({"visual"} if self.shared_backbone else set())
        actor_keys = {"actor"} | (set() if self.shared_backbone else {"visual"})
        self._critic_named, self._actor_named = named(critic_keys), named(actor_keys)
        self.critic_tx = Optimizer(critic_optim_cfg, self._critic_named)
        self.actor_tx = Optimizer(actor_optim_cfg, self._actor_named)
        alpha_cfg = dict(alpha_optim_cfg or {"type": "Adam", "lr": 3e-4})
        alpha_cfg.pop("param_cfg", None)
        self.alpha_tx = Optimizer(alpha_cfg, [("log_alpha", self.log_alpha)])
        self.taus = build_tau_tree(update_coeff, (n for n, _ in self.target.named_parameters()))

    # ------------------------------------------------------------------ act
    def act(self, obs, mode: str) -> torch.Tensor:
        head_mode = "eval" if mode in ("eval", "mean") else "explore"
        out, _ = self.model.actor_apply(obs, mode=head_mode, generator=self.generator)
        return out

    # -------------------------------------------------------------- update
    def _prepare_batch(self, sampled: Dict) -> Dict:
        batch = dict(sampled)
        if self.use_episode_dones:
            batch["dones"] = batch["episode_dones"]
        for key in ("rewards", "dones"):
            if np.ndim(batch[key]) == 1:
                batch[key] = np.asarray(batch[key])[:, None]
        keep = ("obs", "next_obs", "actions", "rewards", "dones")
        return to_torch({k: batch[k] for k in keep}, self.device)

    def update_parameters(self, memory, updates: int) -> Dict[str, float]:
        """One gradient step on a batch sampled from a host replay."""
        batch = self._prepare_batch(memory.sample(self.batch_size))
        metrics = self._update_step(batch)
        keys = sorted(metrics)
        values = torch.stack([metrics[k].detach().float().reshape(()) for k in keys]).cpu().tolist()
        out = dict(zip(keys, values))
        p = self.metric_prefix
        if out.pop(f"{p}/actor_updated") < 0.5:
            for k in _ACTOR_KEYS:
                out.pop(f"{p}/{k}", None)
        out[f"{p}/target_entropy"] = self.target_entropy
        out[f"{p}/grad_steps"] = 1
        return out

    def _compute_q_target(self, batch) -> torch.Tensor:
        """Entropy-regularised min-over-heads bootstrap target [B, 1]; call
        without autograd.  With a shared target backbone the target critic
        reads the live encoder, so the actor's next-obs feature is reused."""
        model = self.model
        share_next = self.shared_backbone and model.shared_target_backbone and model.visual is not None
        (next_actions, neg_logp), feat_next = model.actor_apply(
            batch["next_obs"], mode="max-entropy", generator=self.generator)
        q_next = model.target_critic_apply(self.target, batch["next_obs"], actions=next_actions,
                                           visual_feature=feat_next if share_next else None)
        min_q_next = q_next.min(dim=-1, keepdim=True).values + self.log_alpha.exp() * neg_logp
        rewards = batch["rewards"] * self.reward_scale
        if self.ignore_dones:
            return rewards + self.gamma * min_q_next
        return rewards + (1.0 - batch["dones"].float()) * self.gamma * min_q_next

    def _critic_step(self, batch, q_target):
        model = self.model
        q, feat = model.critic_apply(batch["obs"], actions=batch["actions"], return_feature=True)
        loss = ((q - q_target) ** 2).mean() * model.num_q
        grads = self._step(loss, self._critic_named, self.critic_tx)
        err = (q - q_target).abs().max()
        return loss, q.detach(), global_grad_norm(grads), err, (feat.detach() if feat is not None else None)

    def _actor_alpha_step(self, batch, saved_feat):
        model = self.model
        obs = batch["obs"]
        alpha = self.log_alpha.detach().exp()
        reuse = saved_feat if (self.shared_backbone and self.detach_actor_feature
                               and self.stale_actor_feature) else None
        (pi, neg_logp), feat = model.actor_apply(obs, mode="max-entropy", generator=self.generator,
                                                 detach_visual=self.detach_actor_feature,
                                                 visual_feature=reuse)
        entropy_term = neg_logp.mean()
        vf = feat.detach() if (self.shared_backbone and feat is not None) else None
        q_pi = model.critic_apply(obs, actions=pi, visual_feature=vf).min(dim=-1).values.mean()
        actor_loss = -(q_pi + alpha * entropy_term)
        grads = self._step(actor_loss, self._actor_named, self.actor_tx)

        if self.automatic_alpha_tuning:
            alpha_loss = self.log_alpha.exp() * (entropy_term.detach() - self.target_entropy)
            self.alpha_tx.step(grads_of(alpha_loss, [self.log_alpha]))
        else:
            alpha_loss = torch.zeros((), device=self.device)
        return actor_loss, alpha_loss, entropy_term, global_grad_norm(grads)

    @staticmethod
    def _step(loss, named, tx: Optimizer) -> List[Optional[torch.Tensor]]:
        """Gradients of ``loss`` over ``named`` (all of them count in the
        grad norm); ``tx`` steps the ones it trains."""
        names = [n for n, _ in named]
        grads = grads_of(loss, [p for _, p in named])
        by_name = dict(zip(names, grads))
        tx.step([by_name[n] for n in tx.names])
        return grads

    def _update_step(self, batch) -> Dict[str, torch.Tensor]:
        p = self.metric_prefix
        with torch.no_grad():
            q_target = self._compute_q_target(batch)
        critic_loss, q, critic_gnorm, abs_err, saved_feat = self._critic_step(batch, q_target)

        zero = torch.zeros((), device=self.device)
        if self.updates % self.actor_update_interval == 0:
            a_loss, al_loss, ent, a_gnorm = self._actor_alpha_step(batch, saved_feat)
            actor_updated = torch.ones((), device=self.device)
        else:
            a_loss = al_loss = ent = a_gnorm = actor_updated = zero
        if self.updates % self.target_update_interval == 0:
            soft_update(self.target, self.model, self.taus)
        self.updates += 1
        return {
            f"{p}/critic_loss": critic_loss,
            f"{p}/max_critic_abs_err": abs_err,
            f"{p}/alpha": self.log_alpha.exp(),
            f"{p}/q": q.min(dim=-1).values.mean(),
            f"{p}/q_target": q_target.mean(),
            f"{p}/critic_grad": critic_gnorm,
            f"{p}/actor_loss": a_loss,
            f"{p}/alpha_loss": al_loss,
            f"{p}/entropy": ent,
            f"{p}/actor_grad": a_gnorm,
            f"{p}/actor_updated": actor_updated,
        }

    # ---------------------------------------------------------- checkpoint
    def load_params(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Load a ``convert.params_from_jax`` state dict: live networks,
        ``target.*`` and ``log_alpha``.  Optimizer state is left as is."""
        live = {k: v for k, v in state_dict.items() if not k.startswith("target.") and k != "log_alpha"}
        self.model.load_state_dict(live)
        target = {k[len("target."):]: v for k, v in state_dict.items() if k.startswith("target.")}
        if target:
            self.target.load_state_dict(target)
        if "log_alpha" in state_dict:
            with torch.no_grad():
                self.log_alpha.copy_(state_dict["log_alpha"])

    def state_dict(self) -> Dict:
        """The whole train state: networks, target, alpha, the three
        optimizers, the update counter and the sampling generator."""
        return {
            "model": self.model.state_dict(),
            "target": self.target.state_dict(),
            "log_alpha": self.log_alpha.detach().clone(),
            "actor_opt": self.actor_tx.state_dict(),
            "critic_opt": self.critic_tx.state_dict(),
            "alpha_opt": self.alpha_tx.state_dict(),
            "updates": self.updates,
            "generator": self.generator.get_state(),
            "generator_device": self.generator.device.type,
        }

    def load_state_dict(self, state: Dict) -> None:
        self.model.load_state_dict(state["model"])
        self.target.load_state_dict(state["target"])
        with torch.no_grad():
            self.log_alpha.copy_(state["log_alpha"])
        self.actor_tx.load_state_dict(state["actor_opt"])
        self.critic_tx.load_state_dict(state["critic_opt"])
        self.alpha_tx.load_state_dict(state["alpha_opt"])
        self.updates = int(state["updates"])
        # A CPU and a CUDA generator keep different states: a checkpoint
        # moved to another kind of device keeps this agent's own stream.
        if state.get("generator_device") == self.generator.device.type:
            self.generator.set_state(state["generator"].cpu())
