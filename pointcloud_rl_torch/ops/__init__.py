"""Ops of the port: the hand-written CUDA kernel (built from ``csrc/`` at
first use) and the tensor functions of the point-cloud pipeline.

The camera and sampling functions are exported as
``pointcloud_rl_tpu/ops/__init__.py`` exports them, but resolved on first
access, so that importing ``pointcloud_rl_torch.ops.build`` (the env
workers do, through ``native.py``) does not import torch.
"""

import importlib

_EXPORTS = {
    "depth_to_camera_xyz": "camera",
    "fuse_camera_pointclouds": "camera",
    "transform_points": "camera",
    "seg_balanced_downsample": "sampling",
    "uniform_downsample": "sampling",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
