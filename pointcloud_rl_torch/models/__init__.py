"""Network zoo: torch modules built from registry configs.

Port of ``pointcloud_rl_tpu/models``.  The same registries (NETWORK,
REGRESSION) dispatch config ``type`` names.  The encoders (PointNet with
its STNs, the voxel CNN, the 2D CNNs, VN) and the heads on the SAC path
are ported; ``build_all`` raises ``NotImplementedError`` for the rest,
naming the ROADMAP.md item that ports them.
"""

from typing import Optional

import torch

from ..registry import Registry, build_from_cfg

NETWORK = Registry("network")
REGRESSION = Registry("regression")

# Config types of the JAX package that this port does not build yet, with
# the ROADMAP.md queue A item that ports them.
_NOT_PORTED = {
    "RNN": "A4", "GRU": "A4",
    "GaussianHead": "A4", "SoftplusGaussianHead": "A4", "BasicHead": "A4",
    "TanhHead": "A4", "DiscreteBaseHead": "A4",
}
# Types whose constructor draws its initial weights from a generator.
_SEEDED = ("MLP", "LinearMLP", "ConvMLP", "PointNet", "VoxelCNN", "SparseCNN", "NatureCNN", "DMCEncoder",
           "IMPALA", "VNPointNet")


def build_all(cfg, default_args=None, generator: Optional[torch.Generator] = None):
    """Build a module (or list of modules) from whichever registry owns its type."""
    if cfg is None:
        return None
    if isinstance(cfg, (list, tuple)):
        return [build_all(c, default_args, generator) for c in cfg]
    kind = cfg.get("type")
    for reg in (NETWORK, REGRESSION):
        if kind in reg.module_dict:
            cfg = dict(cfg)
            if kind in _SEEDED:
                cfg["generator"] = generator
            return build_from_cfg(cfg, reg, default_args)
    item = _NOT_PORTED.get(kind)
    raise NotImplementedError(
        f"model type {kind!r} is not ported to pointcloud_rl_torch"
        + (f" yet (ROADMAP.md queue A, item {item})" if item else "")
    )


from . import blocks, cnn, heads, pointnet, vn, voxel  # noqa: E402,F401  (registration side effects)
from .actor_critic import ActorCriticModel  # noqa: E402,F401
from .builder import build_actor_critic  # noqa: E402,F401
from .utils import get_kwargs_from_shape, replace_placeholder_with_args  # noqa: E402,F401

__all__ = [
    "NETWORK",
    "REGRESSION",
    "build_all",
    "ActorCriticModel",
    "build_actor_critic",
    "get_kwargs_from_shape",
    "replace_placeholder_with_args",
]
