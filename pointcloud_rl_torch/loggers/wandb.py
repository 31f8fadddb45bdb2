# Copy of pointcloud_rl_tpu/loggers/wandb.py for the PyTorch port, which imports nothing of that package.
"""Weights & Biases backend (optional)."""

from __future__ import annotations

from .base import BaseLogger


class WandbLogger(BaseLogger):
    def __init__(self, log_dir: str = "./", project: str = "pcrl", **kwargs):
        super().__init__(log_dir=log_dir, **kwargs)
        import wandb

        self.run = wandb.init(project=project, dir=log_dir)

    def log_scalar(self, key: str, value: float, step: int) -> None:
        self.run.log({key: value}, step=step)

    def close(self) -> None:
        self.run.finish()
