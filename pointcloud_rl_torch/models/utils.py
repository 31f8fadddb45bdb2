# Copy of pointcloud_rl_tpu/models/utils.py for the PyTorch port (that package's models import flax).
"""Config shape-placeholder resolution.

Parity target: reference ``pyrl/networks/utils.py`` — configs reference env
shapes symbolically (``"pcd_all_channel"``, ``"action_shape * 2"``,
``slice("action_shape", None, None)``) and are resolved against the live
env's observation/action shapes before networks are built.
"""

from __future__ import annotations

from copy import deepcopy
from numbers import Number
from typing import Any, Dict, Optional

import numpy as np

PCD_KEYS = ["pointcloud", "full_pcd", "no_robot", "handle_only", "fused_pcd", "fused_ball_pcd", "pointcloud_3d_ann", "particles"]
IMAGE_KEYS = ["rgb", "rgbd", "depth", "xyz", "seg"]


def get_kwargs_from_shape(obs_shape, action_shape) -> Dict[str, Any]:
    """Derive substitutable kwargs from env shapes (reference utils.py:24-79)."""
    kwargs: Dict[str, Any] = {}
    if action_shape is not None:
        kwargs["action_shape"] = deepcopy(action_shape)

    if isinstance(obs_shape, dict):
        assert not ("state" in obs_shape and "agent" in obs_shape), f"{obs_shape}"
        for key in ("state", "agent"):
            if key in obs_shape:
                shape = obs_shape[key]
                kwargs["agent_shape"] = shape[-1] if isinstance(shape, (tuple, list)) else shape

        visual_shape = obs_shape
        if "xyz" in obs_shape and obs_shape["xyz"][-2] == 3:
            visual_key = "pointcloud"
        else:
            candidates = [k for k in obs_shape if k in PCD_KEYS or k in IMAGE_KEYS]
            visual_key = candidates[0] if candidates else None

        if visual_key in PCD_KEYS:
            pcd_all, pcd_xyz_rgb = 0, 0
            for name in ("xyz", "rgb"):
                if name in visual_shape:
                    pcd_xyz_rgb += visual_shape[name][-2]
                    pcd_all += visual_shape[name][-2]
            if "pos_encoding" in visual_shape:
                pcd_all += visual_shape["pos_encoding"][-2]
            if "seg" in visual_shape:
                pcd_all += visual_shape["seg"][-2]
                kwargs["num_objs"] = visual_shape["seg"][-2]
            kwargs["pcd_all_channel"] = pcd_all
            kwargs["pcd_xyz_rgb_channel"] = pcd_xyz_rgb
            kwargs["pcd_xyz_channel"] = 3
            kwargs["num_points"] = visual_shape["xyz"][-1]
        elif visual_key in IMAGE_KEYS:
            if "rgb" in visual_shape:
                num_images = visual_shape["rgb"][0] // 3
            elif "depth" in visual_shape:
                num_images = visual_shape["depth"][0]
            else:
                num_images = 1
            kwargs["image_size"] = tuple(visual_shape[visual_key][-2:])
            kwargs["num_images"] = num_images
            kwargs["num_pixels"] = int(np.prod(kwargs["image_size"]))
            kwargs["image_channels"] = sum(visual_shape[name][0] for name in IMAGE_KEYS if name in visual_shape)
            if "depth" in visual_shape and "seg" in visual_shape:
                kwargs["seg_per_image"] = visual_shape["seg"][0] // num_images
    else:
        kwargs["obs_shape"] = deepcopy(obs_shape)
    return kwargs


def replace_placeholder_with_args(parameters: Any, **kwargs) -> Any:
    """Recursively substitute placeholder names in config values and eval
    arithmetic strings like ``"128 + agent_shape"`` (reference utils.py:82-119)."""
    if parameters is None:
        return None
    if isinstance(parameters, dict):
        return type(parameters)({k: replace_placeholder_with_args(v, **kwargs) for k, v in parameters.items()})
    if isinstance(parameters, (tuple, list)):
        return type(parameters)(replace_placeholder_with_args(p, **kwargs) for p in parameters)
    if isinstance(parameters, Number):
        return parameters
    if isinstance(parameters, slice):
        return slice(
            replace_placeholder_with_args(parameters.start, **kwargs),
            replace_placeholder_with_args(parameters.stop, **kwargs),
            replace_placeholder_with_args(parameters.step, **kwargs),
        )
    if isinstance(parameters, str):
        out = parameters
        for key, val in kwargs.items():
            if key in out:
                out = out.replace(key, str(val))
        try:
            ret = eval(out)  # noqa: S307 — config-author-controlled expressions
            return out if callable(ret) else ret
        except Exception:
            return out
    return parameters
