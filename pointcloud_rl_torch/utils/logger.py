# Copy of pointcloud_rl_tpu/utils/logger.py (the parts the port calls) for the PyTorch port, which imports nothing of that package.
"""Colored console + per-run file logging (reference pyrl/utils/meta/logger.py role)."""

from __future__ import annotations

import logging
import os
import sys
import time
from typing import Optional

_LOGGERS = {}

_COLORS = {
    logging.DEBUG: "\033[36m",
    logging.INFO: "\033[32m",
    logging.WARNING: "\033[33m",
    logging.ERROR: "\033[31m",
    logging.CRITICAL: "\033[35m",
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        if sys.stderr.isatty():
            color = _COLORS.get(record.levelno, "")
            return f"{color}{msg}{_RESET}"
        return msg


def get_logger(name: str = "pcrl", work_dir: Optional[str] = None, level: int = logging.INFO, with_stream: bool = True) -> logging.Logger:
    """Get (and memoize) a logger, optionally adding a timestamped file handler."""
    logger = logging.getLogger(name)
    key = (name, work_dir)
    if key in _LOGGERS:
        return _LOGGERS[key]

    logger.setLevel(level)
    logger.propagate = False
    fmt = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"
    if with_stream and not any(isinstance(h, logging.StreamHandler) and not isinstance(h, logging.FileHandler) for h in logger.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(_ColorFormatter(fmt))
        sh.setLevel(level)
        logger.addHandler(sh)
    if work_dir is not None:
        os.makedirs(work_dir, exist_ok=True)
        ts = time.strftime("%Y%m%d_%H%M%S")
        fh = logging.FileHandler(os.path.join(work_dir, f"{ts}-train.log"))
        fh.setFormatter(logging.Formatter(fmt))
        fh.setLevel(level)
        logger.addHandler(fh)
    _LOGGERS[key] = logger
    return logger
