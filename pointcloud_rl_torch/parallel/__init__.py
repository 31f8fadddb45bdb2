"""Data-parallel training over ``torch.distributed`` ranks, on one host or
across hosts (port of ``pointcloud_rl_tpu/parallel``)."""

from .distributed import DistVar, allreduce_stats, init_distributed, is_lead_process
from .mesh import DataParallel, replicate_rollout, setup_data_parallel

__all__ = [
    "DataParallel",
    "DistVar",
    "allreduce_stats",
    "init_distributed",
    "is_lead_process",
    "replicate_rollout",
    "setup_data_parallel",
]
