"""Soft Actor-Critic: continuous, discrete and recurrent.

Port of ``pointcloud_rl_tpu/algorithms/sac.py``: twin-Q targets with the
entropy bonus, MSE critic loss x num_q, interval-gated actor/alpha/target
updates on the agent's own update counter (starting at 0), automatic alpha
tuning (against a label-smoothed target entropy for discrete actions), the
shared visual backbone trained by the critic with detached actor features,
and per-path regex EMA rates.  Discrete actions bootstrap from
``V = sum pi * Q`` and the actor maximises ``sum pi * min Q``.  A
recurrent model updates on ``[B, H]`` windows from ``sample_windows``
(``_update_step_recurrent``) and threads its rnn state through ``act``.
``obs_rms`` normalises a host replay's flat-state batches.

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

With ``obs_transfer_cfg`` (``algorithms/obs_transfer.py``) a batch whose
obs lack the constant pos_encoding block gets it back on the device in
``_prepare_batch``, before anything else touches the obs.
``pre_process`` augmentations run on obs and next_obs at the start of the
update, and a subclass's ``inference_aug`` on the obs of ``act``; both draw
from the agent's generator, on its device.  A batch may come from a host
replay (numpy) or a device replay (tensors already on the device).

The update programs are the JAX package's: ``update_parameters_lazy``
(one update, its metric vector left on the device), ``update_parameters_scan``
(``n`` updates sampling a ``DeviceReplayMemory`` on the device, their
metric vectors summed; a host replay, a recurrent model or ``obs_rms`` take
``n`` lazy updates), ``update_parameters`` (a lazy update whose metrics are
fetched) and the act-fused updates (``set_fused_updates``: each explore
``forward_async`` of the next collection takes a chunk of updates, then
acts, in one program).  On a card each program is a captured CUDA graph of
the eager step (``algorithms/graphs.py``), on an NCCL rank with its
gradient all-reduces inside; on the CPU, and on a gloo rank (whose
collectives run on the host), the eager step runs.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models import build_actor_critic
from ..models.builder import extract_freeze_param_cfg
from ..ops.augment import build_data_augmentations
from ..utils.stats import RunningMeanStd
from ..utils.tree_ops import tree_map
from . import MFRL
from .base import BaseAgent, to_torch
from .graphs import UpdatePrograms, input_signature
from .optim import Optimizer, build_tau_tree, global_grad_norm, grads_of, soft_update

_ACTOR_KEYS = ("actor_loss", "alpha_loss", "entropy", "actor_grad", "q_match_rate")


@MFRL.register_module()
class SAC(BaseAgent):
    inference_aug = None  # augmentations of the obs in ``act``; DrQ sets its own

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
        device="cuda",
    ):
        super().__init__(device)
        self.init_obs_transfer(obs_transfer_cfg, env_params["obs_shape"])
        self.is_discrete = bool(env_params["is_discrete"])
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
        self.obs_processor = build_data_augmentations(pre_process)
        # host-side normalisation of flat-state batches (the update's only;
        # ``act`` sees raw observations, as in the JAX package)
        self.obs_rms = None
        if obs_rms:
            shape = env_params["obs_shape"]
            if isinstance(shape, dict):
                raise ValueError("obs_rms supports flat state observations")
            self.obs_rms = RunningMeanStd(shape=(shape if isinstance(shape, int) else int(np.prod(shape)),))

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
        self.seed = int(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        # ``act``'s draws; a data-parallel agent gives them a stream of their own
        self.act_generator = self.generator
        self.modules = {"model": self.model, "target": self.target}

        action_shape = env_params["action_shape"]
        init_log_alpha = float(np.log(np.float32(alpha)))
        if target_entropy is not None:
            self.target_entropy = float(target_entropy)
        elif self.is_discrete:
            n = int(np.prod(action_shape))
            explore_rate = (1 - target_smooth) / max(n - 1, 1)
            self.target_entropy = float(-(target_smooth * np.log(target_smooth)
                                          + (n - 1) * explore_rate * np.log(explore_rate)))
            init_log_alpha = float(np.log(0.1))
        else:
            self.target_entropy = -float(np.prod(action_shape))
        self.log_alpha = torch.nn.Parameter(torch.tensor(init_log_alpha, device=self.device))
        self.updates = 0  # gradient steps taken: gates the actor and target updates
        # the gates repeat with this period: a captured program is one per phase of it
        self._gate_period = math.lcm(self.actor_update_interval, self.target_update_interval)
        self._metric_keys: Optional[List[str]] = None
        self._programs: Optional[UpdatePrograms] = None  # the captured update programs (on a card)
        self._fused_vec_sum = None

        # Each optimizer owns the subtrees of the JAX package's masks (the
        # shared rnn goes with the shared backbone), minus param_cfg
        # exclusions; each loss is differentiated over its own subtrees.
        def named(keys):
            return [(n, p) for n, p in self.model.named_parameters() if n.split(".")[0] in keys]

        shared = {"visual", "rnn"}
        critic_keys = {"critic", "critic_visual"} | (shared if self.shared_backbone else set())
        actor_keys = {"actor"} | (set() if self.shared_backbone else shared)
        self._critic_named, self._actor_named = named(critic_keys), named(actor_keys)
        # the recurrent critic's gradient (and its norm) spans every encoder and the rnn
        self._critic_named_rnn = named({"critic", "critic_visual", "visual", "rnn"})
        self.critic_tx = Optimizer(critic_optim_cfg, self._critic_named)
        self.actor_tx = Optimizer(actor_optim_cfg, self._actor_named)
        alpha_cfg = dict(alpha_optim_cfg or {"type": "Adam", "lr": 3e-4})
        alpha_cfg.pop("param_cfg", None)
        self.alpha_tx = Optimizer(alpha_cfg, [("log_alpha", self.log_alpha)])
        self.taus = build_tau_tree(update_coeff, (n for n, _ in self.target.named_parameters()))

    # ------------------------------------------------------------------ act
    def act(self, obs, mode: str) -> torch.Tensor:
        head_mode = "eval" if mode in ("eval", "mean") else "explore"
        if self.inference_aug is not None and isinstance(obs, dict):
            obs = self.inference_aug(self.act_generator, obs)
        if not self.model.is_recurrent:
            out, _ = self.model.actor_apply(obs, mode=head_mode, generator=self.act_generator)
            return out
        leaf = obs if not isinstance(obs, dict) else next(iter(obs.values()))
        if self._rnn_states is None or self._rnn_states.shape[0] != leaf.shape[0]:
            self._rnn_states = self.model.rnn.initial_state(leaf.shape[0], self.device)
        out, _, self._rnn_states = self.model.actor_apply(obs, mode=head_mode, generator=self.act_generator,
                                                          rnn_states=self._rnn_states, rnn_mode="with_states")
        return out

    # -------------------------------------------------------------- update
    def _host_batch(self, sampled: Dict) -> Dict:
        """The batch's preparation before it goes to the device: episode
        dones, ``obs_rms`` (host batches only), ``[B, 1]`` rewards and
        dones, the keys the update reads."""
        batch = dict(sampled)
        if self.use_episode_dones:
            batch["dones"] = batch["episode_dones"]
        if self.obs_rms is not None:
            if not isinstance(batch["obs"], np.ndarray):
                raise TypeError("obs_rms requires a host replay buffer")
            self.obs_rms.update(batch["obs"])
            batch["obs"] = self.obs_rms.normalize(batch["obs"])
            batch["next_obs"] = self.obs_rms.normalize(batch["next_obs"])
        for key in ("rewards", "dones"):
            if batch[key].ndim == 1:  # numpy or tensor alike
                batch[key] = batch[key][:, None]
        keep = ("obs", "next_obs", "actions", "rewards", "dones", "is_valid")
        return {k: batch[k] for k in keep if k in batch}

    def _complete_batch(self, batch: Dict) -> Dict:
        """Re-attach a pos_encoding block the replay did not store, on the
        device, before any augmentation, so the channel order xyz, rgb,
        pos_encoding, seg holds."""
        batch = dict(batch)
        for key in ("obs", "next_obs"):
            if isinstance(batch.get(key), dict):
                batch[key] = self._device_obs(batch[key])
        return batch

    def _prepare_batch(self, sampled: Dict) -> Dict:
        return self._complete_batch(to_torch(self._host_batch(sampled), self.device))

    def set_data_parallel(self, dp) -> None:
        """Make this agent a rank of ``dp`` (``parallel.setup_data_parallel``):
        its optimizers all-reduce their gradients, its update keeps this
        rank's rows of the global batch, and ``act`` draws from a generator
        of its own, since only the lead acts and the update's generator must
        stay in the same state on every rank."""
        self.data_parallel = dp
        for tx in (self.critic_tx, self.actor_tx, self.alpha_tx):
            tx.data_parallel = dp
        self.act_generator = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        self.drop_programs()

    # --------------------------------------------------- update programs
    def _graphed(self) -> bool:
        """Whether the update programs are captured CUDA graphs: on a card,
        where the data-parallel collectives can be captured (none outside a
        process group, NCCL's; not gloo's, which run on the host)."""
        return self.device.type == "cuda" and self.data_parallel.capturable

    def drop_programs(self) -> None:
        """Free the captured update programs (their CUDA graphs and pool).
        An NCCL rank does so before its process group is destroyed: NCCL
        frees a communicator only once no graph holds its collectives."""
        if self._programs is not None:
            self._programs.invalidate()

    def _program(self, kind: str, n: int, body, inputs=None, memory=None):
        """``body(inputs)``, which takes ``n`` updates (and may act), as the
        program ``kind`` (``algorithms/graphs.py``): a replay of its CUDA
        graph on a card, the eager body elsewhere.  Returns its outputs."""
        if not self._graphed():
            return body(None if inputs is None else to_torch(inputs, self.device))
        if self._programs is None:
            self._programs = UpdatePrograms(self, self.device)
        key = (kind, n, self.updates % self._gate_period, input_signature(inputs), self.model.training)
        generators = (self.generator, self.act_generator, getattr(memory, "generator", None))
        return self._programs.run(key, n, body, inputs, generators, memory)

    def _samples_on_device(self, memory) -> bool:
        """The JAX package's rule for the storage programs: a
        ``DeviceReplayMemory``, a feed-forward model, no ``obs_rms``."""
        from ..env.device_replay import DeviceReplayMemory

        return isinstance(memory, DeviceReplayMemory) and not self.model.is_recurrent and self.obs_rms is None

    def update_parameters_lazy(self, memory, updates: int) -> torch.Tensor:
        """One gradient step (``updates`` is unused: the agent counts its
        own); returns its metric vector on the device, in the order of
        ``_metric_keys``, without waiting for it.  A device replay is
        sampled inside the program; a host batch (a recurrent model's
        windows, ``obs_rms`` applied) is sampled here and copied into it."""
        if self._samples_on_device(memory):
            return self._program("storage", 1, lambda _: (self._update_vec(memory),), memory=memory)[0]
        batch = self._host_batch(self._sample(memory))
        return self._program("batch", 1, lambda b: (self._batch_update_vec(self._complete_batch(b)),),
                             inputs=batch)[0]

    def update_parameters(self, memory, updates: int) -> Dict[str, float]:
        """One gradient step on a batch sampled from ``memory`` (a host or a
        device replay; a recurrent model samples ``[B, H]`` windows), with
        its metrics fetched.  A data-parallel rank samples and prepares the
        global batch, updates on its rows and averages the metrics over the
        ranks."""
        vec = self.update_parameters_lazy(memory, updates)
        out = dict(zip(self._metric_keys, vec.cpu().tolist()))
        p = self.metric_prefix
        if out.pop(f"{p}/actor_updated") < 0.5:
            for k in _ACTOR_KEYS:
                out.pop(f"{p}/{k}", None)
        if not self.is_discrete:
            out.pop(f"{p}/q_match_rate", None)
        out[f"{p}/target_entropy"] = self.target_entropy
        out[f"{p}/grad_steps"] = 1
        return out

    def update_parameters_scan(self, memory, n: int) -> torch.Tensor:
        """``n`` gradient steps, each on its own sample of ``memory``;
        returns the SUM of their metric vectors on the device, without
        waiting for it (the JAX package's scanned program).  Over a
        ``DeviceReplayMemory`` they are one program; otherwise ``n`` lazy
        updates.  ``reduce_metric_vecs`` turns sums into the logged
        averages."""
        if not self._samples_on_device(memory):
            total = None
            for i in range(n):
                vec = self.update_parameters_lazy(memory, i)
                total = vec if total is None else total + vec
            return total
        return self._program("storage", n, lambda _: (self._update_vecs(memory, n),), memory=memory)[0]

    def reduce_metric_vecs(self, vec_sum: torch.Tensor, count: int) -> Dict[str, float]:
        """Average summed metric vectors (one device fetch); the actor's
        metrics average over the updates where the actor stepped."""
        sums = dict(zip(self._metric_keys, vec_sum.double().cpu().tolist()))
        p = self.metric_prefix
        n_actor = max(sums.pop(f"{p}/actor_updated", count), 1.0)
        actor_keys = {f"{p}/{k}" for k in _ACTOR_KEYS}
        metrics = {k: v / (n_actor if k in actor_keys else max(count, 1)) for k, v in sums.items()}
        if not self.is_discrete:
            metrics.pop(f"{p}/q_match_rate", None)
        metrics[f"{p}/target_entropy"] = self.target_entropy
        metrics[f"{p}/grad_steps"] = count
        return metrics

    # ------------------------------------------------ act-fused updates
    def set_fused_updates(self, memory, chunk: int, budget: int, announce=None) -> bool:
        """Arm act-fused updates for the next collection: each explore
        ``forward_async`` takes ``chunk`` gradient steps, then acts with the
        stepped parameters, in one program, until ``budget`` updates have
        run; ``announce(chunk)`` (a host lead's ``announce_updates``) is
        called before each such program.  Returns False (not armed) where
        the storage programs do not apply (a host replay, a recurrent model,
        ``obs_rms``) or the replay is empty."""
        if not (self._samples_on_device(memory) and len(memory) > 0 and chunk >= 1):
            return False
        self._fused_plan = {"mem": memory, "chunk": int(chunk), "budget": int(budget), "done": 0,
                            "announce": announce}
        self._fused_vec_sum = None
        return True

    def finish_fused_updates(self):
        """Disarm the plan; returns (the summed metric vector on the device
        or None, the gradient steps taken)."""
        plan, self._fused_plan = self._fused_plan, None
        vec, self._fused_vec_sum = self._fused_vec_sum, None
        return vec, (plan["done"] if plan else 0)

    def _fused_act_dispatch(self, obs):
        """One chunk of updates and the explore act under the armed plan, on
        the act's host-side obs (``_host_obs``); returns the actions on the
        device, or None when the budget has no chunk left (the caller acts
        as usual)."""
        plan = self._fused_plan
        chunk, mem = plan["chunk"], plan["mem"]
        if plan["budget"] < chunk:
            return None
        if plan["announce"] is not None:
            plan["announce"](chunk)

        def body(o):
            with torch.enable_grad():
                vec = self._update_vecs(mem, chunk)
            return vec, self.act(self._device_obs(o), "explore")

        vec, actions = self._program("act", chunk, body, inputs=obs, memory=mem)
        plan["budget"] -= chunk
        plan["done"] += chunk
        self._fused_vec_sum = vec if self._fused_vec_sum is None else self._fused_vec_sum + vec
        return actions

    # ------------------------------------------------------ the eager step
    def _sample(self, memory):
        if self.model.is_recurrent:
            if not hasattr(memory, "sample_windows"):
                raise TypeError("Recurrent agents need T-step window sampling: use the host ReplayMemory with "
                                "sampling_cfg type TStepTransition")
            return memory.sample_windows(self.batch_size, getattr(memory.sampling, "horizon", 8))
        return memory.sample(self.batch_size)

    def _update_vec(self, memory) -> torch.Tensor:
        """One gradient step on a fresh sample of ``memory``: its metrics as
        one vector on the device, in the order of ``_metric_keys``."""
        return self._batch_update_vec(self._prepare_batch(self._sample(memory)))

    def _update_vecs(self, memory, n: int) -> torch.Tensor:
        """``n`` of ``_update_vec``, their vectors summed."""
        total = None
        for _ in range(n):
            vec = self._update_vec(memory)
            total = vec if total is None else total + vec
        return total

    def _batch_update_vec(self, batch) -> torch.Tensor:
        """One gradient step on a prepared batch on the device."""
        dp = self.data_parallel
        with dp.sharded_draws():
            metrics = self._update_step(dp.shard(batch))
        self._metric_keys = keys = sorted(metrics)
        vec = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
        return dp.reduce_metrics(vec, [k.endswith("/max_critic_abs_err") for k in keys])

    def _compute_q_target(self, batch, reward_scale: Optional[float] = None) -> torch.Tensor:
        """Entropy-regularised min-over-heads bootstrap target [B, 1]; call
        without autograd.  With a shared target backbone the target critic
        reads the live encoder, so the actor's next-obs feature is reused.
        ``reward_scale`` overrides the agent's (DrQ's target omits it)."""
        model = self.model
        share_next = (self.shared_backbone and model.shared_target_backbone and model.visual is not None
                      and model.rnn is None)
        (next_actions, neg_logp), feat_next = model.actor_apply(
            batch["next_obs"], mode="max-entropy", generator=self.generator)
        vf = feat_next if share_next else None
        if self.is_discrete:  # next_actions are the probabilities, neg_logp the entropy
            q_next = model.target_critic_apply(self.target, batch["next_obs"], actions_prob=next_actions,
                                               visual_feature=vf)
        else:
            q_next = model.target_critic_apply(self.target, batch["next_obs"], actions=next_actions,
                                               visual_feature=vf)
        min_q_next = q_next.min(dim=-1, keepdim=True).values + self.log_alpha.exp() * neg_logp
        rewards = batch["rewards"] * (self.reward_scale if reward_scale is None else reward_scale)
        if self.ignore_dones:
            return rewards + self.gamma * min_q_next
        return rewards + (1.0 - batch["dones"].float()) * self.gamma * min_q_next

    def _critic_step(self, batch, q_target, critic_obs=None, critic_actions=None):
        model = self.model
        obs = batch["obs"] if critic_obs is None else critic_obs
        actions = batch["actions"] if critic_actions is None else critic_actions
        q, feat = model.critic_apply(obs, actions=actions, return_feature=True)
        loss = ((q - q_target) ** 2).mean() * model.num_q
        grads = self._step(loss, self._critic_named, self.critic_tx)
        err = (q - q_target).abs().max()
        saved = feat.detach() if feat is not None else None
        return loss, q.detach(), global_grad_norm(grads, self.device), err, saved

    def _actor_alpha_step(self, batch, saved_feat, actor_obs=None):
        model = self.model
        obs = batch["obs"] if actor_obs is None else actor_obs
        alpha = self.log_alpha.detach().exp()
        reuse = saved_feat if (self.shared_backbone and self.detach_actor_feature
                               and self.stale_actor_feature) else None
        (pi, neg_logp), feat = model.actor_apply(obs, mode="max-entropy", generator=self.generator,
                                                 detach_visual=self.detach_actor_feature,
                                                 visual_feature=reuse)
        entropy_term = neg_logp.mean()
        q_match = torch.zeros((), device=self.device)
        if self.is_discrete:  # pi holds the probabilities
            q_min = model.critic_apply(obs, detach_value=True).min(dim=-2).values  # [B, A]
            q_pi = (q_min * pi).sum(-1).mean()
            q_match = (pi.argmax(-1) == q_min.argmax(-1)).float().mean()
        else:
            vf = feat.detach() if (self.shared_backbone and feat is not None) else None
            q_pi = model.critic_apply(obs, actions=pi, visual_feature=vf).min(dim=-1).values.mean()
        actor_loss = -(q_pi + alpha * entropy_term)
        grads = self._step(actor_loss, self._actor_named, self.actor_tx)
        alpha_loss = self._alpha_step(entropy_term)
        return actor_loss, alpha_loss, entropy_term, global_grad_norm(grads, self.device), q_match

    def _alpha_step(self, entropy_term: torch.Tensor) -> torch.Tensor:
        if not self.automatic_alpha_tuning:
            return torch.zeros((), device=self.device)
        alpha_loss = self.log_alpha.exp() * (entropy_term.detach() - self.target_entropy)
        self.alpha_tx.step(grads_of(alpha_loss, [self.log_alpha]))
        return alpha_loss

    @staticmethod
    def _step(loss, named, tx: Optimizer, norm_keys=None) -> List[Optional[torch.Tensor]]:
        """Gradients of ``loss`` over ``named``; ``tx`` steps the ones it
        trains.  Returns the gradients that count in the grad norm: all,
        or those under the top-level keys ``norm_keys``."""
        names = [n for n, _ in named]
        by_name = dict(zip(names, grads_of(loss, [p for _, p in named])))
        trained = set(tx.names)
        rest = [n for n in names if n not in trained]
        stepped, extra = tx.step([by_name[n] for n in tx.names], [by_name[n] for n in rest])
        by_name.update(zip(tx.names, stepped))  # a data-parallel rank's are averaged over the ranks
        by_name.update(zip(rest, extra))
        return [g for n, g in by_name.items() if norm_keys is None or n.split(".")[0] in norm_keys]

    def _update_step(self, batch) -> Dict[str, torch.Tensor]:
        if self.model.is_recurrent:
            return self._update_step_recurrent(batch)
        if self.obs_processor is not None:
            batch = dict(batch)
            batch["obs"] = self.obs_processor(self.generator, batch["obs"])
            batch["next_obs"] = self.obs_processor(self.generator, batch["next_obs"])
        with torch.no_grad():
            q_target = self._compute_q_target(batch)
        critic = self._critic_step(batch, q_target)
        return self._finish_update(batch, q_target, critic)

    def _finish_update(self, batch, q_target, critic, actor_obs=None) -> Dict[str, torch.Tensor]:
        """After the critic step: the gated actor/alpha step (on ``actor_obs``
        when given, reusing the matching rows of the critic's saved feature),
        the gated target EMA, the counter, and the metrics."""
        critic_loss, q, critic_gnorm, abs_err, saved_feat = critic
        return self._gated_steps(critic_loss, q, q_target, critic_gnorm, abs_err,
                                 lambda: self._actor_alpha_step(batch, saved_feat, actor_obs))

    def _gated_steps(self, critic_loss, q, q_target, critic_gnorm, abs_err, actor_step) -> Dict[str, torch.Tensor]:
        """``actor_step`` (returning actor loss, alpha loss, entropy, actor
        grad norm, q-match rate) when the actor interval fires, the target
        EMA when the target interval fires, the counter, and the metrics."""
        p = self.metric_prefix
        zero = torch.zeros((), device=self.device)
        if self.updates % self.actor_update_interval == 0:
            a_loss, al_loss, ent, a_gnorm, q_match = actor_step()
            actor_updated = torch.ones((), device=self.device)
        else:
            a_loss = al_loss = ent = a_gnorm = q_match = actor_updated = zero
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
            f"{p}/q_match_rate": q_match,
            f"{p}/actor_updated": actor_updated,
        }

    def _update_step_recurrent(self, batch) -> Dict[str, torch.Tensor]:
        """The update over ``[B, H]`` windows: the target runs the actor and
        the target critic over the sequence [first obs, next_obs...] of H+1
        frames, so the rnn state at each next obs carries the window's
        history; the losses are means over the valid frames (``is_valid``).
        The actor re-encodes the obs whatever ``stale_actor_feature`` says,
        and no ``pre_process`` runs, as in the JAX package."""
        model = self.model
        is_valid = batch["is_valid"][..., None].float()  # [B, H, 1]
        n_valid = batch.get("valid_frames", is_valid.sum())  # a data-parallel shard's normaliser
        next_seq = tree_map(lambda o, n: torch.cat([o[:, :1], n], dim=1), batch["obs"], batch["next_obs"])
        # A target that owns only the critic reads the live encoder and rnn,
        # from the same zero state: its feature IS the actor's, so it is
        # passed on rather than encoded again (the JAX package encodes twice).
        share_next = self.shared_backbone and model.shared_target_backbone
        with torch.no_grad():
            (next_actions, neg_logp), feat_next = model.actor_apply(next_seq, mode="max-entropy",
                                                                    generator=self.generator, seq=True)
            q_next = model.target_critic_apply(self.target, next_seq, actions=next_actions, seq=True,
                                               visual_feature=feat_next if share_next else None)
            min_q_next = (q_next.min(dim=-1, keepdim=True).values + self.log_alpha.exp() * neg_logp)[:, 1:]
            rewards = batch["rewards"] * self.reward_scale
            if self.ignore_dones:
                q_target = rewards + self.gamma * min_q_next
            else:
                q_target = rewards + (1.0 - batch["dones"].float()) * self.gamma * min_q_next

        q = model.critic_apply(batch["obs"], actions=batch["actions"], seq=True)  # [B, H, num_q]
        err = (q - q_target) ** 2 * is_valid
        critic_loss = err.sum() / (n_valid * model.num_q).clamp_min(1.0) * model.num_q
        grads = self._step(critic_loss, self._critic_named_rnn, self.critic_tx)
        abs_err = ((q - q_target).abs() * is_valid).max()

        def actor_step():
            alpha = self.log_alpha.detach().exp()
            (pi, nlp), feat = model.actor_apply(batch["obs"], mode="max-entropy", generator=self.generator, seq=True,
                                                detach_visual=self.detach_actor_feature)
            ent = (nlp * is_valid).sum() / n_valid.clamp_min(1.0)
            vf = feat.detach() if (self.shared_backbone and feat is not None) else None
            q_pi = model.critic_apply(batch["obs"], actions=pi, visual_feature=vf, seq=True)
            q_pi = q_pi.min(dim=-1, keepdim=True).values
            actor_loss = -((q_pi * is_valid).sum() / n_valid.clamp_min(1.0) + alpha * ent)
            a_grads = self._step(actor_loss, self._actor_named, self.actor_tx, norm_keys={"actor"})
            alpha_loss = self._alpha_step(ent)
            zero = torch.zeros((), device=self.device)
            return actor_loss, alpha_loss, ent, global_grad_norm(a_grads, self.device), zero

        return self._gated_steps(critic_loss, q.detach(), q_target, global_grad_norm(grads, self.device), abs_err,
                                 actor_step)

    # ---------------------------------------------------------- checkpoint
    def load_params(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Load a ``convert.params_from_jax`` state dict: live networks,
        ``target.*`` and ``log_alpha``.  Optimizer state is left as is."""
        self.drop_programs()
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
            "act_generator": self.act_generator.get_state(),
            "generator_device": self.generator.device.type,
        }

    def load_state_dict(self, state: Dict) -> None:
        self.drop_programs()  # the optimizers' loaded state replaces the tensors the programs read
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
            if self.act_generator is not self.generator and "act_generator" in state:
                self.act_generator.set_state(state["act_generator"].cpu())
