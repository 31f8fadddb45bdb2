"""pointcloud_rl_torch — the PyTorch/CUDA port of pointcloud_rl_tpu.

SAC from segmented point clouds with a PointNet encoder whose fused body
is a hand-written CUDA kernel for Hopper (``csrc/pointnet_fused.cu``).
The package imports ``torch`` and never JAX; the host code it shares with
``pointcloud_rl_tpu`` (config, registry, utils, loggers) is JAX-free.
Importing this package imports neither torch nor any env module, so env
worker processes stay light.
"""
