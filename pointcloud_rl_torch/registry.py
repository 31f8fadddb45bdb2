# Copy of pointcloud_rl_tpu/registry.py (the parts the port calls) for the PyTorch port, which imports nothing of that package.
"""String-keyed component registry.

The whole framework is config-driven: every layer (networks, algorithms, envs,
replays, loggers, ...) exposes a :class:`Registry`, and config dicts select
implementations with a ``type="Name"`` key.  This mirrors the public API of the
reference framework (see reference ``pyrl/utils/meta/registry.py``) while the
implementation here is original and free of torch.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class Registry:
    """A name -> class/callable map with a config-driven factory."""

    def __init__(self, name: str):
        self._name = name
        self._module_dict: Dict[str, Any] = {}

    @property
    def name(self) -> str:
        return self._name

    @property
    def module_dict(self) -> Dict[str, Any]:
        return self._module_dict

    def __len__(self) -> int:
        return len(self._module_dict)

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict

    def __repr__(self) -> str:
        return f"Registry(name={self._name}, items={list(self._module_dict)})"

    def get(self, key: str) -> Optional[Any]:
        return self._module_dict.get(key)

    def register_module(self, name: Optional[str] = None, module: Optional[Any] = None, force: bool = False):
        """Register a class or callable, usable as decorator or direct call."""
        if module is not None:
            self._do_register(name or module.__name__, module, force)
            return module

        def _decorator(cls):
            self._do_register(name or cls.__name__, cls, force)
            return cls

        return _decorator

    def _do_register(self, name: str, module: Any, force: bool) -> None:
        if not callable(module):
            raise TypeError(f"module must be callable, got {type(module)}")
        if not force and name in self._module_dict:
            raise KeyError(f"{name} is already registered in {self._name}")
        self._module_dict[name] = module


def build_from_cfg(cfg: Optional[dict], registry: Registry, default_args: Optional[dict] = None) -> Any:
    """Instantiate ``registry[cfg['type']](**cfg_without_type, **default_args)``.

    ``cfg`` may also carry a callable directly under ``type``.  ``None`` configs
    build to ``None`` so optional components can be expressed as missing keys.
    """
    if cfg is None:
        return None
    if not isinstance(cfg, dict):
        raise TypeError(f"cfg must be a dict, got {type(cfg)}")
    if "type" not in cfg and (default_args is None or "type" not in default_args):
        raise KeyError(f"cfg must contain the key 'type': {cfg}")

    args = dict(cfg)
    if default_args is not None:
        for k, v in default_args.items():
            args.setdefault(k, v)

    obj_type = args.pop("type")
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
        if obj_cls is None:
            raise KeyError(f"{obj_type} is not in the {registry.name} registry. Available: {sorted(registry.module_dict)}")
    elif callable(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f"type must be a str or callable, got {type(obj_type)}")

    try:
        return obj_cls(**args)
    except TypeError as e:
        raise TypeError(f"Failed building {obj_type} from {registry.name}: {e}") from e
