"""Construct an :class:`ActorCriticModel` from actor/critic configs.

Port of ``pointcloud_rl_tpu/models/builder.py``: with a shared backbone
the critic's visual config is discarded and both read ``model.visual``;
otherwise the critic builds its own encoder.  Every module draws its
initial weights from one ``torch.Generator``, in a fixed order.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Optional, Tuple

import numpy as np
import torch

from . import build_all
from .actor_critic import ActorCriticModel, ActorHead, CriticEnsemble
from .blocks import MLP

_MLP_TYPES = ("MLP", "LinearMLP", "ConvMLP")
_MLP_FIELDS = ("mlp_spec", "norm_cfg", "act_cfg", "bias", "inactivated_output", "ignore_first_ln",
               "zero_out_indices", "dtype")


def _mlp_kwargs(cfg: Optional[dict]) -> Optional[dict]:
    if cfg is None:
        return None
    cfg = dict(cfg)
    assert cfg.pop("type") in _MLP_TYPES, f"Critic/actor final mlp must be an MLP type, got {cfg}"
    return {k: cfg[k] for k in _MLP_FIELDS if k in cfg}


def _split_nn_cfg(nn_cfg: Optional[dict]) -> Tuple[Optional[dict], Optional[dict]]:
    """Split an nn_cfg into (visual_nn_cfg, mlp_cfg); a bare MLP nn_cfg is
    a state-only network."""
    if nn_cfg is None:
        return None, None
    nn_cfg = dict(nn_cfg)
    t = nn_cfg.get("type")
    if t is not None and "Visuomotor" in t:
        return nn_cfg.get("visual_nn_cfg"), nn_cfg.get("mlp_cfg")
    if t in _MLP_TYPES:
        return None, nn_cfg
    return nn_cfg, None


def _head_cfg_with_bound(head_cfg: Optional[dict], action_space) -> Optional[dict]:
    if head_cfg is None:
        return None
    head_cfg = dict(head_cfg)
    if action_space is not None and getattr(action_space, "is_bounded", lambda: False)():
        head_cfg["bound"] = [np.asarray(action_space.low), np.asarray(action_space.high)]
    return head_cfg


def extract_freeze_param_cfg(nn_cfg: Optional[dict]) -> dict:
    """Visuomotor freeze flags -> optimizer exclusion regexes."""
    out = {}
    if nn_cfg:
        if nn_cfg.get("freeze_visual_nn"):
            out["(.*?)visual_nn(.*?)"] = None
        if nn_cfg.get("freeze_mlp"):
            out["^actor(.*?)"] = None
    return out


def build_actor_critic(
    actor_cfg: dict,
    critic_cfg: dict,
    env_params: dict,
    shared_backbone: bool = False,
    shared_target_backbone: Optional[bool] = None,
    bf16: bool = False,
    generator: Optional[torch.Generator] = None,
) -> ActorCriticModel:
    """Build the live networks on the CPU; the caller moves them to its device."""
    if bf16:
        raise NotImplementedError("the bf16 agent flag is not ported to pointcloud_rl_torch yet "
                                  "(ROADMAP.md queue A, item A1)")
    if env_params.get("is_discrete", False):
        raise NotImplementedError("discrete actions are not ported to pointcloud_rl_torch yet "
                                  "(ROADMAP.md queue A, item A4)")
    actor_cfg, critic_cfg = deepcopy(dict(actor_cfg)), deepcopy(dict(critic_cfg))
    action_shape = env_params.get("action_shape")
    action_space = env_params.get("action_space")
    if shared_target_backbone is None:
        shared_target_backbone = shared_backbone

    actor_cfg.pop("type", "ContinuousActor")
    critic_cfg.pop("type", "ContinuousCritic")
    num_q = int(critic_cfg.pop("num_heads", 1))
    if critic_cfg.pop("share_feature", False):
        raise NotImplementedError("critic_cfg.share_feature is not ported to pointcloud_rl_torch yet "
                                  "(ROADMAP.md queue A, item A4)")

    # ---- actor --------------------------------------------------------
    if dict(actor_cfg.get("nn_cfg") or {}).get("rnn_cfg"):
        raise NotImplementedError("recurrent policies are not ported to pointcloud_rl_torch yet "
                                  "(ROADMAP.md queue A, item A4)")
    actor_visual_cfg, actor_mlp_cfg = _split_nn_cfg(actor_cfg.get("nn_cfg"))
    head_cfg = _head_cfg_with_bound(actor_cfg.get("head_cfg"), action_space)
    if head_cfg is not None:
        head_cfg.setdefault("dim_output", int(np.prod(action_shape)))
    visual = build_all(actor_visual_cfg, generator=generator)
    final_mlp = MLP(**_mlp_kwargs(actor_mlp_cfg), generator=generator) if actor_mlp_cfg else None
    actor = ActorHead(final_mlp=final_mlp, head=build_all(head_cfg))

    # ---- critic -------------------------------------------------------
    critic_visual_cfg, critic_mlp_cfg = _split_nn_cfg(critic_cfg.get("nn_cfg"))
    critic_visual = None
    if not shared_backbone:
        # the critic's own encoder, or an independent copy of the actor's
        cfg = critic_visual_cfg if critic_visual_cfg is not None else actor_visual_cfg
        critic_visual = build_all(cfg, generator=generator)

    assert critic_mlp_cfg is not None, "Critic requires an MLP (Visuomotor mlp_cfg or plain MLP nn_cfg)"
    critic = CriticEnsemble(MLP(**_mlp_kwargs(critic_mlp_cfg), num_heads=num_q, generator=generator))

    return ActorCriticModel(
        visual=visual,
        critic_visual=critic_visual,
        actor=actor,
        critic=critic,
        shared_backbone=shared_backbone,
        shared_target_backbone=shared_target_backbone,
        num_q=num_q,
    )
