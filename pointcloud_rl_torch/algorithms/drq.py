"""DrQ / SVEA: SAC regularized with K-fold data augmentation.

Port of ``pointcloud_rl_tpu/algorithms/drq.py``: obs and next_obs are
repeat-interleaved ``num_aug`` times and augmented; the bootstrap target is
averaged over the augmentations; SVEA (``num_aug=1``) interleaves
(augmented, original) rows for the critic and computes the target from the
ORIGINAL next_obs; the actor updates on the first augmented copy (SVEA: the
original), reusing the matching rows of the critic forward's feature; act
may augment (``inference_aug``).  Like the reference, the target omits
``reward_scale``.

The augmentations run on the batch's device with the agent's generator.
A packed batch (``{"pcd": [B, N, C]}`` from a ``DeviceReplayMemory`` with
``pack_features``) takes xyz-only stacks on its xyz channels in place.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.augment import apply_augs_to_packed, augs_are_xyz_only, build_data_augmentations
from ..utils.tree_ops import tree_map
from . import MFRL
from .sac import SAC


def _repeat_interleave(tree, k: int):
    return tree_map(lambda x: x.repeat_interleave(k, dim=0), tree)


def _interleave_pairs(tree_a, tree_b):
    """[B] x [B] -> [2B] as [a0, b0, a1, b1, ...]."""
    return tree_map(lambda a, b: torch.stack([a, b], dim=1).reshape((-1,) + tuple(a.shape[1:])), tree_a, tree_b)


@MFRL.register_module()
class DrQ(SAC):
    def __init__(self, num_aug=2, obs_aug=None, svea=False, inference_aug=None, *args, **kwargs):
        if svea and num_aug != 1:
            raise ValueError("SVEA only needs num_aug=1")
        self.num_aug = int(num_aug)
        self.svea = bool(svea)
        self.obs_aug = build_data_augmentations(obs_aug)
        self.inference_aug = self.obs_aug if inference_aug == "same" else build_data_augmentations(inference_aug)
        kwargs.setdefault("metric_prefix", "drq")
        super().__init__(*args, **kwargs)

    def _apply_obs_aug(self, obs):
        """Raw obs dicts take the stack as it is; packed storage gets it on
        its xyz channels (xyz-only stacks only)."""
        if self.obs_aug is None:
            return obs
        if isinstance(obs, dict) and "pcd" in obs:
            if not augs_are_xyz_only(self.obs_aug):
                raise ValueError("pack_features replay storage supports xyz-only augmentation stacks "
                                 "(GlobalRotScaleTrans/RandomJitterPoints on xyz); use raw-dict storage "
                                 "for rgb/seg/point-count augmentations")
            return apply_augs_to_packed(self.obs_aug, self.generator, obs)
        return self.obs_aug(self.generator, obs)

    def _update_step(self, batch) -> Dict[str, torch.Tensor]:
        K = self.num_aug
        B = batch["rewards"].shape[0]
        aug_obs = self._apply_obs_aug(_repeat_interleave(batch["obs"], K))
        if not self.svea:
            target_batch = {
                "next_obs": self._apply_obs_aug(_repeat_interleave(batch["next_obs"], K)),
                "rewards": batch["rewards"].repeat_interleave(K, dim=0),
                "dones": batch["dones"].repeat_interleave(K, dim=0),
            }
            with torch.no_grad():
                q_target = self._compute_q_target(target_batch, reward_scale=1.0)
            # the mean over the K copies, repeated back to [B*K, 1]
            q_target = q_target.reshape(B, K).mean(dim=1, keepdim=True).repeat_interleave(K, dim=0)
            critic_obs = aug_obs
            critic_actions = batch["actions"].repeat_interleave(K, dim=0)
        else:
            with torch.no_grad():
                q_target = self._compute_q_target(batch, reward_scale=1.0)
            q_target = q_target.repeat_interleave(K + 1, dim=0)
            critic_obs = _interleave_pairs(aug_obs, batch["obs"])
            critic_actions = batch["actions"].repeat_interleave(K + 1, dim=0)
        critic = self._critic_step(batch, q_target, critic_obs=critic_obs, critic_actions=critic_actions)

        # The actor's rows of the critic's saved feature: copy 0 of each
        # sample is every K-th row; SVEA's originals are the odd rows.
        loss, q, gnorm, err, saved_feat = critic
        if self.svea:
            actor_obs = batch["obs"]
            actor_feat = saved_feat[1::2] if saved_feat is not None else None
        else:
            actor_obs = tree_map(lambda x: x.reshape((B, K) + tuple(x.shape[1:]))[:, 0], aug_obs)
            actor_feat = saved_feat[::K] if saved_feat is not None else None
        return self._finish_update(batch, q_target, (loss, q, gnorm, err, actor_feat), actor_obs=actor_obs)
