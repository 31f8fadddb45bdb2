"""Model-free RL algorithms (the MFRL registry): SAC, DrQ/SVEA and DDPG/TD3."""

from ..registry import Registry, build_from_cfg

MFRL = Registry("mfrl")


def build_agent(cfg, default_args=None):
    return build_from_cfg(cfg, MFRL, default_args)


from .sac import SAC  # noqa: E402,F401
from .drq import DrQ  # noqa: E402,F401
from .ddpg import DDPG  # noqa: E402,F401

__all__ = ["MFRL", "build_agent", "SAC", "DrQ", "DDPG"]
