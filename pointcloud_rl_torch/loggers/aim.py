# Copy of pointcloud_rl_tpu/loggers/aim.py for the PyTorch port, which imports nothing of that package.
"""Aim backend (the reference configs' default; optional here)."""

from __future__ import annotations

from .base import BaseLogger


class AimLogger(BaseLogger):
    def __init__(self, log_dir: str = "./", experiment: str = "pcrl", **kwargs):
        super().__init__(log_dir=log_dir, **kwargs)
        import aim

        self.run = aim.Run(repo=log_dir, experiment=experiment)

    def log_scalar(self, key: str, value: float, step: int) -> None:
        self.run.track(value, name=key, step=step)

    def close(self) -> None:
        self.run.close()
