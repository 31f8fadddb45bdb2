"""Model cost analysis with ``torch.utils.flop_counter`` (port of
``pointcloud_rl_tpu/utils/flops.py``, which asks XLA's compiler).

``FlopCounterMode`` counts the FLOP of the ops it has a formula for while
the function runs eagerly: the products and convolutions (``mm``,
``addmm``, ``bmm``, ``baddbmm``, the convolutions and attention), two FLOP
per multiply-add, backward ops included when the function runs a
backward.  It counts nothing for elementwise ops, reductions, LayerNorm or
the max-pool, which XLA's cost analysis does count, and nothing for a
custom kernel (the fused PointNet body on a CUDA tensor): run the function
on CPU tensors, where that body is its plain torch version, to count it.
XLA's ``bytes accessed`` has no counterpart here.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from .tree_ops import tree_leaves


def cost_analysis(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """Run ``fn(*args, **kwargs)`` once under ``FlopCounterMode``:
    ``{"flops": ...}``."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops())}


def estimate_flops(fn: Callable, *args, **kwargs) -> float:
    return cost_analysis(fn, *args, **kwargs)["flops"]


def count_params(params) -> int:
    """Elements of a module's parameters, or of every leaf of a tree of
    tensors or arrays."""
    leaves = params.parameters() if isinstance(params, torch.nn.Module) else tree_leaves(params)
    return int(sum(x.numel() if isinstance(x, torch.Tensor) else np.prod(np.shape(x)) for x in leaves))


def model_report(module: torch.nn.Module, obs) -> Dict[str, Any]:
    """Parameters and forward FLOP of ``module`` on an example input (no
    autograd graph)."""
    with torch.no_grad():
        flops = estimate_flops(module, obs)
    return {"params": count_params(module), "flops": flops}
