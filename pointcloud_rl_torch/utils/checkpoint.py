"""Checkpoint I/O (port of ``pointcloud_rl_tpu/utils/checkpoint.py``).

One file per checkpoint, ``work_dir/models/model_<step>`` plus the
``model_final`` alias, holding ``torch.save`` of the agent's whole train
state (networks, target, alpha, optimizers, update counter, generator).
``find_checkpoint`` is the auto-resume scan of the JAX package.  torch is
imported where a checkpoint is read or written, so the CLI module (which
the env workers' forkserver re-imports) stays free of it.
"""

from __future__ import annotations

import os
import os.path as osp
import re
from typing import Any, Optional, Tuple


def save_checkpoint(state: Any, work_dir: str, step: int, name: Optional[str] = None) -> str:
    """``torch.save`` the train state to ``work_dir/models/model_<step>``
    (written to a temporary file and renamed, so a crash never leaves half
    a checkpoint under the final name)."""
    import torch

    models_dir = osp.join(osp.abspath(work_dir), "models")
    os.makedirs(models_dir, exist_ok=True)
    path = osp.join(models_dir, name or f"model_{step}")
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def load_checkpoint(path: str, device="cpu", keys_map: Optional[dict] = None) -> Any:
    """Load a train state onto ``device``.  ``keys_map``: {regex: replacement}
    applied to the parameter names of every state dict inside."""
    import torch

    state = torch.load(osp.abspath(path), map_location=device, weights_only=False)
    if keys_map:
        state = remap_keys(state, keys_map)
    return state


def remap_keys(tree: Any, keys_map: dict) -> Any:
    """Rename dict keys (recursively) by regex substitution."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        nk = k
        if isinstance(k, str):
            for pat, rep in keys_map.items():
                nk = re.sub(pat, rep, nk)
        out[nk] = remap_keys(v, keys_map)
    return out


def find_checkpoint(work_dir: str) -> Tuple[Optional[str], int]:
    """Latest ``models/model_<step>`` under work_dir (auto-resume scan)."""
    models_dir = osp.join(work_dir, "models")
    if not osp.isdir(models_dir):
        return None, 0
    best, best_step = None, -1
    for name in os.listdir(models_dir):
        m = re.fullmatch(r"model_(\d+)", name)
        if m and int(m.group(1)) > best_step:
            best, best_step = osp.join(models_dir, name), int(m.group(1))
    if best is None and osp.exists(osp.join(models_dir, "model_final")):
        return osp.join(models_dir, "model_final"), 0
    return best, max(best_step, 0)
