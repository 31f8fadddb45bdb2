"""Parameter names between the JAX package and the port.

Modules of the port are registered under the flax names of their JAX
counterparts (``visual.conv.Dense_0``, ``critic.VmapMLP_0.Dense_1``,
``visual.final_ln``, ...), so a torch parameter name and a flax path
differ only in their leaf:

    flax ``Dense`` ``kernel`` [in, out]  <->  ``Linear.weight`` [out, in]
    stacked critic ``kernel`` [H, in, out] <-> ``weight`` [H, in, out] (as is)
    flax ``Conv`` ``kernel`` [k..., in, out] <-> ``Conv{2,3}d.weight`` [out, in, k...]
    sparse conv ``sparse_conv{i}_kernel`` [K^3, in, out] <-> the same name (as is)
    ``LayerNorm`` ``scale``               <->  ``weight``
    ``bias``                               <->  ``bias``

``params_from_jax`` turns the JAX agent's parameter trees (nested dicts of
numpy arrays) into a state dict for the port's SAC agent; optimizer state
does not come across.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

# Top-level keys shown under the reference's module name to the optimizer
# and EMA regexes, so configs written against "visual_nn" apply verbatim.
_PATH_ALIASES = {"visual": "visual_nn", "critic_visual": "visual_nn"}


def _is_norm(module_name: str) -> bool:
    return module_name.startswith("LayerNorm") or module_name == "final_ln"


def flax_path(name: str) -> Tuple[str, ...]:
    """Torch parameter name -> key path of the same leaf in the flax tree."""
    parts = name.split(".")
    if parts[-1] == "weight" and len(parts) >= 2:
        parts[-1] = "scale" if _is_norm(parts[-2]) else "kernel"
    return tuple(parts)


def regex_path(name: str) -> str:
    """The slash-joined path the JAX package matches ``param_cfg`` and
    ``update_coeff`` regexes against, with the ``visual -> visual_nn`` alias."""
    parts = list(flax_path(name))
    parts[0] = _PATH_ALIASES.get(parts[0], parts[0])
    return "/".join(parts)


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
        return out
    return {prefix: np.asarray(tree)}


def _to_torch_name(path: Tuple[str, ...], value: np.ndarray) -> Tuple[str, np.ndarray]:
    parts = list(path)
    if parts[-1] == "kernel":
        parts[-1] = "weight"
        if value.ndim == 2:  # a plain Dense; stacked critic kernels stay [H, in, out]
            value = value.T
        elif value.ndim >= 4:  # a 2D or 3D conv
            value = value.transpose((value.ndim - 1, value.ndim - 2) + tuple(range(value.ndim - 2)))
    elif parts[-1] == "scale":
        parts[-1] = "weight"
    return ".".join(parts), value


def params_from_jax(params: dict, target_params: Optional[dict] = None,
                    log_alpha: Optional[Any] = None) -> Dict[str, torch.Tensor]:
    """JAX ``params`` (and ``target_params``, ``log_alpha``) -> a state dict.

    Keys of the live networks are as in ``ActorCriticModel.state_dict()``;
    the target's carry a ``target.`` prefix; ``log_alpha`` is a 0-d tensor."""
    sd: Dict[str, torch.Tensor] = {}
    for prefix, tree in (("", params), ("target.", target_params or {})):
        for path, value in _flatten(tree).items():
            name, value = _to_torch_name(path, value)
            sd[prefix + name] = torch.tensor(np.asarray(value, np.float32))
    if log_alpha is not None:
        sd["log_alpha"] = torch.tensor(float(np.asarray(log_alpha)), dtype=torch.float32)
    return sd
