"""Actor / critic applications (port of ``pointcloud_rl_tpu/models/actor_critic.py``).

``ActorCriticModel`` owns the live networks as submodules::

    visual         the actor's visual encoder (read by the critic too when
                   the backbone is shared; absent for state-only obs)
    critic_visual  the critic's own visual encoder (only when NOT shared)
    actor          final MLP + head
    critic         the stacked critic ensemble

and ``make_target()`` builds the target subset: always ``critic``, plus the
visual encoders when the target does NOT share the live backbone.  The
names match the JAX package's top-level parameter keys.
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


class ActorCriticModel(nn.Module):
    def __init__(
        self,
        visual: Optional[nn.Module],
        critic_visual: Optional[nn.Module],
        actor: ActorHead,
        critic: CriticEnsemble,
        shared_backbone: bool = True,
        shared_target_backbone: bool = True,
        num_q: int = 2,
    ):
        super().__init__()
        self.visual = visual
        self.critic_visual = critic_visual
        self.actor = actor
        self.critic = critic
        self.shared_backbone = shared_backbone
        self.shared_target_backbone = shared_target_backbone
        self.num_q = num_q

    # ------------------------------------------------------------- target
    def make_target(self) -> nn.ModuleDict:
        """Hard copies of the subtrees the target owns, frozen."""
        target = nn.ModuleDict({"critic": copy.deepcopy(self.critic)})
        if not self.shared_target_backbone:
            for key in ("visual", "critic_visual"):
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

    def encode(self, obs, which: str = "actor", source: Optional[nn.Module] = None):
        """Visual feature of ``obs`` (None without a visual encoder).

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
        return module(vis_obs), robot_state, vis_obs

    def _features(self, obs, which: str, visual_feature, detach_visual: bool = False,
                  source: Optional[nn.Module] = None):
        """visual -> concat robot state.  Returns (features, visual feature).

        ``detach_visual`` runs the encode without autograd, which is what
        the JAX package's stop_gradient computes, and lets the fused
        PointNet take its max-only kernel."""
        vis_obs, robot_state = split_obs(obs)
        if visual_feature is not None:
            feat = visual_feature
        elif detach_visual:
            with torch.no_grad():
                feat, robot_state, vis_obs = self.encode(obs, which, source)
        else:
            feat, robot_state, vis_obs = self.encode(obs, which, source)
        return self._with_state(feat, robot_state, vis_obs), feat

    def actor_apply(self, obs, mode: str = "explore", generator: Optional[torch.Generator] = None,
                    detach_visual: bool = False, visual_feature=None):
        """Actor forward: returns (head output, visual feature); with
        mode="max-entropy" the head output is (action, neg_logp)."""
        x, feat = self._features(obs, "actor", visual_feature, detach_visual)
        return self.actor(x, mode=mode, generator=generator), feat

    def _critic_heads(self, critic, obs, actions, visual_feature, source=None):
        x, feat = self._features(obs, "critic", visual_feature, source=source)
        if actions is not None:
            x = torch.cat([x, actions], dim=-1)
        return critic(x), feat  # [B, heads, out]

    def critic_apply(self, obs, actions=None, visual_feature=None, return_feature: bool = False):
        """Q-values [B, num_q]; ``return_feature`` also returns the forward's
        visual feature, which the actor step may reuse."""
        q, feat = self._critic_heads(self.critic, obs, actions, visual_feature)
        q = q[..., 0]
        return (q, feat) if return_feature else q

    def target_critic_apply(self, target: nn.ModuleDict, obs, actions=None, visual_feature=None):
        """Target critic; a shared-target backbone reads the LIVE visual
        encoder, so the caller may pass the live next-obs feature."""
        assert visual_feature is None or self.shared_target_backbone, (
            "visual_feature reuse requires the shared-target backbone")
        q, _ = self._critic_heads(target["critic"], obs, actions, visual_feature, source=target)
        return q[..., 0]
