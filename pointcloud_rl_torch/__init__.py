"""pointcloud_rl_torch — the PyTorch/CUDA port of pointcloud_rl_tpu.

SAC from segmented point clouds with a PointNet encoder whose fused body
is a hand-written CUDA kernel for Hopper (``csrc/pointnet_fused.cu``).
The package imports ``torch`` and never JAX, and nothing of
``pointcloud_rl_tpu``: it keeps its own copies of the host code it needs
(config, registry, utils, loggers, the native sampler).
Importing this package imports neither torch nor any env module, so env
worker processes stay light.
"""

from .version import __version__

__all__ = ["__version__"]
