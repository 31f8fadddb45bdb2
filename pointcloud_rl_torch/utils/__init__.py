"""Utilities of the port: checkpoint I/O and its own copies of the JAX-free
helpers of ``pointcloud_rl_tpu.utils`` (logger, stats, timer, tree ops, ...)."""
