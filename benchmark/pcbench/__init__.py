"""The benchmark of ``pointcloud_rl_torch``: the harness, the traffic drivers,
the plain reference and the yardstick (roofline, FLOP count, trace readers).
It imports nothing of ``pointcloud_rl_tpu`` or JAX."""
