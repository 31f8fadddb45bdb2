# Copy of pointcloud_rl_tpu/loggers/tensorboard.py for the PyTorch port, which imports nothing of that package.
"""TensorBoard backend via tensorboardX (reference tensorboard_logger.py)."""

from __future__ import annotations

from .base import BaseLogger


class TensorboardLogger(BaseLogger):
    def __init__(self, log_dir: str = "./", **kwargs):
        super().__init__(log_dir=log_dir, **kwargs)
        from tensorboardX import SummaryWriter

        self.writer = SummaryWriter(log_dir)

    def log_scalar(self, key: str, value: float, step: int) -> None:
        self.writer.add_scalar(key, value, step)

    def close(self) -> None:
        self.writer.close()
