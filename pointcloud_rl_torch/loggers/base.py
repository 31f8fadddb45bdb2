# Copy of pointcloud_rl_tpu/loggers/base.py for the PyTorch port, which imports nothing of that package.
"""Logger base + CSV mirror (reference exp_logger/base_logger.py:7-48:
every backend also mirrors scalars into a CSV for offline analysis)."""

from __future__ import annotations

import csv
import os
import os.path as osp
from typing import Dict, Optional


class CSVLogger:
    def __init__(self, log_dir: str = "./", filename: str = "metrics.csv", **kwargs):
        os.makedirs(log_dir, exist_ok=True)
        self.path = osp.join(log_dir, filename)
        self._fieldnames = None

    def log(self, metrics: Dict[str, float], step: int, tag: Optional[str] = None) -> None:
        row = {"step": step}
        for k, v in metrics.items():
            key = f"{tag}/{k}" if tag else k
            try:
                row[key] = float(v)
            except (TypeError, ValueError):
                continue
        exists = osp.exists(self.path)
        if self._fieldnames is None:
            if exists:
                with open(self.path) as f:
                    reader = csv.reader(f)
                    self._fieldnames = next(reader, ["step"])
            else:
                self._fieldnames = list(row)
        new_fields = [k for k in row if k not in self._fieldnames]
        if new_fields:
            self._fieldnames += new_fields
            self._rewrite_with_fields()
        with open(self.path, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fieldnames)
            if not exists:
                writer.writeheader()
            writer.writerow(row)

    def _rewrite_with_fields(self) -> None:
        if not osp.exists(self.path):
            return
        with open(self.path) as f:
            rows = list(csv.DictReader(f))
        with open(self.path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fieldnames)
            writer.writeheader()
            for r in rows:
                writer.writerow(r)

    def close(self) -> None:
        pass


class BaseLogger:
    """Backend base: subclasses implement log_scalar; scalars mirror to CSV."""

    def __init__(self, log_dir: str = "./", with_csv: bool = True, **kwargs):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.csv = CSVLogger(log_dir) if with_csv else None

    def log_scalar(self, key: str, value: float, step: int) -> None:
        raise NotImplementedError

    def log(self, metrics: Dict[str, float], step: int, tag: Optional[str] = None) -> None:
        for k, v in metrics.items():
            key = f"{tag}/{k}" if tag else k
            try:
                self.log_scalar(key, float(v), step)
            except (TypeError, ValueError):
                continue
        if self.csv is not None:
            self.csv.log(metrics, step, tag)

    def close(self) -> None:
        pass
