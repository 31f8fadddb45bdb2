"""Utilities of the port.  The JAX-free helpers of ``pointcloud_rl_tpu.utils``
(logger, stats, timer, tree ops) are imported from there."""
