# Copy of pointcloud_rl_tpu/loggers/__init__.py for the PyTorch port, which imports nothing of that package.
"""Experiment metric loggers (reference pyrl/utils/exp_logger/)."""

from ..registry import Registry, build_from_cfg
from .base import BaseLogger, CSVLogger
from .tensorboard import TensorboardLogger

EXP_LOGGER = Registry("exp_logger")
EXP_LOGGER.register_module(name="csv", module=CSVLogger)
EXP_LOGGER.register_module(name="tensorboard", module=TensorboardLogger)
EXP_LOGGER.register_module(name="tb", module=TensorboardLogger)


def _build_optional(name, module_path, class_name):
    def _factory(**kwargs):
        import importlib

        mod = importlib.import_module(module_path)
        return getattr(mod, class_name)(**kwargs)

    EXP_LOGGER.register_module(name=name, module=_factory)


_build_optional("aim", "pointcloud_rl_torch.loggers.aim", "AimLogger")
_build_optional("wandb", "pointcloud_rl_torch.loggers.wandb", "WandbLogger")


def build_exp_logger(cfg, default_args=None):
    """Build; fall back to tensorboard when an optional backend is missing
    (the reference defaults to aim, which is not shipped here)."""
    if cfg is None:
        return None
    try:
        return build_from_cfg(dict(cfg), EXP_LOGGER, default_args)
    except ImportError:
        fallback = dict(cfg)
        fallback["type"] = "tensorboard"
        return build_from_cfg(fallback, EXP_LOGGER, default_args)


__all__ = ["EXP_LOGGER", "build_exp_logger", "BaseLogger", "CSVLogger", "TensorboardLogger"]
