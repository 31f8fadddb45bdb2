# Copy of pointcloud_rl_tpu/version.py for the PyTorch port.
__version__ = "0.1.0"
