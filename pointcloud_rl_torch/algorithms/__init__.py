"""Model-free RL algorithms (the MFRL registry)."""

from ..registry import Registry, build_from_cfg

MFRL = Registry("mfrl")

# Agents of the JAX package not ported yet, with their ROADMAP.md queue A item.
_NOT_PORTED = {"DrQ": "A2", "DDPG": "A4"}


def build_agent(cfg, default_args=None):
    kind = cfg.get("type")
    if kind in _NOT_PORTED:
        raise NotImplementedError(f"agent {kind!r} is not ported to pointcloud_rl_torch yet "
                                  f"(ROADMAP.md queue A, item {_NOT_PORTED[kind]})")
    return build_from_cfg(cfg, MFRL, default_args)


from .sac import SAC  # noqa: E402,F401

__all__ = ["MFRL", "build_agent", "SAC"]
