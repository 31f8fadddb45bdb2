"""Actor / critic applications (port of ``pointcloud_rl_tpu/models/actor_critic.py``).

``ActorCriticModel`` owns the live networks as submodules::

    visual         the actor's visual encoder (read by the critic too when
                   the backbone is shared; absent for state-only obs)
    critic_visual  the critic's own visual encoder (only when NOT shared)
    rnn            the recurrent core between the visual feature and the
                   heads, read by actor and critic (recurrent configs only)
    actor          final MLP + head
    critic         the stacked critic ensemble

and ``make_target()`` builds the target subset: always ``critic``, plus the
visual encoders and the rnn when the target does NOT share the live
backbone (DDPG adds ``actor``).  The names match the JAX package's
top-level parameter keys.  Discrete critics output a Q-table over the
choices; ``share_feature`` with ``average_grad`` scales the critic input's
gradient by ``1/num_q``.
"""

from __future__ import annotations

import copy
from typing import Any, Optional, Tuple

import torch
from torch import nn

VISUAL_STRIP_SUBSTRINGS = ("_box", "_seg", "_sem_label")


def split_obs(obs) -> Tuple[Any, Optional[torch.Tensor]]:
    """Split an observation into (visual_obs, robot_state): pop "state" /
    "agent", strip auxiliary ``*_box``/``*_seg``/``visual_state`` keys, and
    unwrap a single-key dict that is not a raw point cloud or image."""
    if not isinstance(obs, dict):
        return obs, None
    obs = dict(obs)
    robot_state = None
    for key in list(obs.keys()):
        if key == "visual_state" or any(s in key for s in VISUAL_STRIP_SUBSTRINGS):
            if key != "seg":  # "seg" itself is a real pointcloud channel
                obs.pop(key)
    for key in ("state", "agent"):
        if key in obs:
            assert robot_state is None, "Only one robot state key allowed"
            robot_state = obs.pop(key)
    if not ("xyz" in obs or "rgb" in obs or "rgbd" in obs or "pcd" in obs) and len(obs) == 1:
        obs = next(iter(obs.values()))
    return obs, robot_state


class ActorHead(nn.Module):
    """final_mlp -> head."""

    def __init__(self, final_mlp: Optional[nn.Module], head: Optional[nn.Module]):
        super().__init__()
        self.final_mlp = final_mlp
        self.head = head

    def forward(self, feat, mode: str = "explore", generator: Optional[torch.Generator] = None):
        if self.final_mlp is not None:
            feat = self.final_mlp(feat)
        if self.head is not None:
            return self.head(feat, mode=mode, generator=generator)
        return feat


class CriticEnsemble(nn.Module):
    """num_heads independent Q-MLPs over concat(feature, action), stacked
    into one MLP with ``[heads, in, out]`` kernels, registered under the
    JAX package's name for the vmapped MLP.  Output [B, heads, out]."""

    def __init__(self, mlp: nn.Module):
        super().__init__()
        self.add_module("VmapMLP_0", mlp)

    def forward(self, feat):
        return self.VmapMLP_0(feat)


def scale_gradient(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Identity whose gradient is scaled by ``scale``, computed as the JAX
    package computes it (so the forward values are the same)."""
    return x * scale + (x * (1.0 - scale)).detach()


def _flatten_time(tree):
    """[B, T, ...] -> [B*T, ...] for per-frame visual encoders."""
    leaf = tree if not isinstance(tree, dict) else next(iter(tree.values()))
    B, T = leaf.shape[:2]
    if isinstance(tree, dict):
        return {k: v.reshape((B * T,) + tuple(v.shape[2:])) for k, v in tree.items()}, B, T
    return tree.reshape((B * T,) + tuple(tree.shape[2:])), B, T


class ActorCriticModel(nn.Module):
    def __init__(
        self,
        visual: Optional[nn.Module],
        critic_visual: Optional[nn.Module],
        actor: ActorHead,
        critic: CriticEnsemble,
        shared_backbone: bool = True,
        shared_target_backbone: bool = True,
        is_discrete: bool = False,
        num_q: int = 2,
        share_feature: bool = False,
        average_grad: bool = True,
        rnn: Optional[nn.Module] = None,
    ):
        super().__init__()
        self.visual = visual
        self.critic_visual = critic_visual
        self.rnn = rnn
        self.actor = actor
        self.critic = critic
        self.shared_backbone = shared_backbone
        self.shared_target_backbone = shared_target_backbone
        self.is_discrete = is_discrete
        self.num_q = num_q
        self.share_feature = share_feature
        self.average_grad = average_grad

    @property
    def is_recurrent(self) -> bool:
        return self.rnn is not None

    # ------------------------------------------------------------- target
    def make_target(self) -> nn.ModuleDict:
        """Hard copies of the subtrees the target owns, frozen."""
        target = nn.ModuleDict({"critic": copy.deepcopy(self.critic)})
        if not self.shared_target_backbone:
            for key in ("visual", "critic_visual", "rnn"):
                if getattr(self, key) is not None:
                    target[key] = copy.deepcopy(getattr(self, key))
        target.requires_grad_(False)
        return target

    # ------------------------------------------------------------- applies
    @staticmethod
    def _with_state(feat, robot_state, vis_obs):
        """Concat the visual feature with the robot state."""
        if feat is None:
            return (robot_state if robot_state is not None else vis_obs).float()
        if robot_state is not None:
            return torch.cat([feat, robot_state.to(feat.dtype)], dim=-1)
        return feat

    def encode(self, obs, which: str = "actor", source: Optional[nn.Module] = None, seq: bool = False):
        """Visual feature of ``obs`` (None without a visual encoder); with
        ``seq`` the obs are ``[B, T, ...]`` and the encoder sees ``B*T`` rows.

        ``source``: a module holding target-owned ``visual``/``critic_visual``
        copies that replace the live ones."""
        vis_obs, robot_state = split_obs(obs)
        module = self.visual
        if which == "critic" and self.critic_visual is not None:
            module = self.critic_visual
        if source is not None:
            name = "critic_visual" if (which == "critic" and self.critic_visual is not None) else "visual"
            if name in source:
                module = source[name]
        if module is None:
            return None, robot_state, vis_obs
        if seq:
            flat, B, T = _flatten_time(vis_obs)
            return module(flat).reshape(B, T, -1), robot_state, vis_obs
        return module(vis_obs), robot_state, vis_obs

    def _features(self, obs, which: str, visual_feature, detach_visual: bool = False,
                  source: Optional[nn.Module] = None, seq: bool = False, rnn_states=None,
                  episode_dones=None, rnn_mode: str = "base"):
        """visual -> [rnn] -> concat robot state.  Returns (features, the
        post-rnn visual feature, the next rnn state or None).

        The robot state enters the rnn's input AND is appended after it.
        ``detach_visual`` runs the encode without autograd, which is what
        the JAX package's stop_gradient computes, and lets the fused
        PointNet take its max-only kernel; the rnn still takes gradients.
        A given ``visual_feature`` is post-rnn: the rnn is skipped."""
        vis_obs, robot_state = split_obs(obs)
        if visual_feature is not None:
            feat = visual_feature
        elif detach_visual:
            with torch.no_grad():
                feat, robot_state, vis_obs = self.encode(obs, which, source, seq)
        else:
            feat, robot_state, vis_obs = self.encode(obs, which, source, seq)
        next_state = None
        if self.rnn is not None and visual_feature is None:
            rnn = source["rnn"] if (source is not None and "rnn" in source) else self.rnn
            # flax's Dense promotes a bf16 input to its f32 parameters
            base = self._with_state(feat, robot_state, vis_obs).float()
            out = rnn(base, rnn_states=rnn_states, episode_dones=episode_dones, rnn_mode=rnn_mode)
            feat, next_state = out if rnn_mode != "base" else (out, None)
        return self._with_state(feat, robot_state, vis_obs), feat, next_state

    def actor_apply(self, obs, mode: str = "explore", generator: Optional[torch.Generator] = None,
                    detach_visual: bool = False, visual_feature=None, seq: bool = False, rnn_states=None,
                    episode_dones=None, rnn_mode: str = "base", source: Optional[nn.Module] = None):
        """Actor forward: returns (head output, visual feature), and the
        next rnn state third when ``rnn_mode != "base"``; with
        mode="max-entropy" the head output is (action, neg_logp).
        ``source``: target-owned subtrees (``actor``, visual, ``rnn``) that
        replace the live ones."""
        x, feat, next_state = self._features(obs, "actor", visual_feature, detach_visual, source, seq,
                                             rnn_states, episode_dones, rnn_mode)
        actor = source["actor"] if (source is not None and "actor" in source) else self.actor
        out = actor(x, mode=mode, generator=generator)
        return (out, feat, next_state) if rnn_mode != "base" else (out, feat)

    def target_actor_apply(self, target: nn.ModuleDict, obs, mode: str = "eval",
                           generator: Optional[torch.Generator] = None, seq: bool = False):
        """Actor forward through the target-owned subtrees (DDPG/TD3's
        a' = pi_target(s')); subtrees the target lacks are the live ones."""
        return self.actor_apply(obs, mode=mode, generator=generator, seq=seq, source=target)

    def _critic_heads(self, critic, obs, actions, visual_feature, source=None, seq: bool = False,
                      episode_dones=None):
        x, feat, _ = self._features(obs, "critic", visual_feature, source=source, seq=seq,
                                    episode_dones=episode_dones)
        if self.share_feature and self.num_q > 1 and self.average_grad:
            x = scale_gradient(x, 1.0 / self.num_q)
        if actions is not None and not self.is_discrete:
            x = torch.cat([x, actions], dim=-1)
        return critic(x), feat  # [..., heads, out]

    def _select_q(self, q, actions, actions_prob):
        """Continuous: [..., num_q].  Discrete: V = sum pi*Q with
        ``actions_prob``, Q of ``actions``, or the raw [..., num_q, A] table."""
        if not self.is_discrete:
            return q[..., 0]
        if actions_prob is not None:
            return (q * actions_prob[..., None, :]).sum(-1)
        if actions is not None:
            idx = actions.long().expand(q.shape[:-1])[..., None]
            return q.gather(-1, idx)[..., 0]
        return q

    def critic_apply(self, obs, actions=None, actions_prob=None, visual_feature=None, detach_value: bool = False,
                     seq: bool = False, episode_dones=None, return_feature: bool = False):
        """Q-values; ``return_feature`` also returns the forward's visual
        feature, which the actor step may reuse."""
        q, feat = self._critic_heads(self.critic, obs, actions, visual_feature, seq=seq,
                                     episode_dones=episode_dones)
        if detach_value:
            q = q.detach()
        q = self._select_q(q, actions, actions_prob)
        return (q, feat) if return_feature else q

    def target_critic_apply(self, target: nn.ModuleDict, obs, actions=None, actions_prob=None, visual_feature=None,
                            seq: bool = False, episode_dones=None):
        """Target critic; a shared-target backbone reads the LIVE visual
        encoder, so the caller may pass the live next-obs feature."""
        assert visual_feature is None or self.shared_target_backbone, (
            "visual_feature reuse requires the shared-target backbone")
        q, _ = self._critic_heads(target["critic"], obs, actions, visual_feature, source=target, seq=seq,
                                  episode_dones=episode_dones)
        return self._select_q(q, actions, actions_prob)
