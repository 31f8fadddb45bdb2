# Copy of pointcloud_rl_tpu/config.py for the PyTorch port, which imports nothing of that package.
"""Python-file config system with ``_base_`` inheritance and CLI overrides.

Behavioral parity with the reference's mmcv-style config
(reference ``pyrl/utils/meta/config.py``): configs are plain Python files
exec'd into a nested dict; ``_base_`` lists parent config files merged
depth-first; ``_delete_=True`` in a child dict replaces instead of merging;
``merge_from_dict`` applies ``--cfg-options a.b.c=v`` style overrides; and
:class:`DictAction` parses nested tuples/lists/bools/numbers from the CLI.

Implementation is original (no addict/yapf dependency): we use a small
attribute-dict class and ``repr``-based pretty dumping.
"""

from __future__ import annotations

import argparse
import ast
import copy
import json
import os
import os.path as osp
import sys
import tempfile
import types
from importlib import util as importlib_util
from typing import Any, Dict, Optional

BASE_KEY = "_base_"
DELETE_KEY = "_delete_"
RESERVED_KEYS = ("filename", "text")


class ConfigDict(dict):
    """dict with attribute access; missing attributes raise AttributeError."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(f"'ConfigDict' object has no attribute '{name}'") from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __deepcopy__(self, memo):
        other = self.__class__()
        memo[id(self)] = other
        for key, value in self.items():
            other[copy.deepcopy(key, memo)] = copy.deepcopy(value, memo)
        return other

    @staticmethod
    def convert(obj: Any) -> Any:
        """Recursively convert plain dicts into ConfigDicts."""
        if isinstance(obj, dict):
            return ConfigDict({k: ConfigDict.convert(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return type(obj)(ConfigDict.convert(v) for v in obj)
        return obj


def _load_py_file(filename: str) -> Dict[str, Any]:
    """Execute a python config file and return its module-level variables."""
    filename = osp.abspath(osp.expanduser(filename))
    if not osp.isfile(filename):
        raise FileNotFoundError(f"Config file not found: {filename}")
    with tempfile.TemporaryDirectory() as tmpdir:
        # Copy so the config file can live anywhere without package shadowing.
        tmp = osp.join(tmpdir, "_cfg_module.py")
        with open(filename, "r") as fsrc, open(tmp, "w") as fdst:
            fdst.write(fsrc.read())
        spec = importlib_util.spec_from_file_location("_cfg_module", tmp)
        mod = importlib_util.module_from_spec(spec)
        sys.modules["_cfg_module"] = mod
        try:
            spec.loader.exec_module(mod)  # type: ignore[union-attr]
            cfg = {k: v for k, v in vars(mod).items() if not k.startswith("__") and not isinstance(v, types.ModuleType)}
        finally:
            sys.modules.pop("_cfg_module", None)
    return cfg


def _merge_a_into_b(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    """Merge override dict ``a`` into base dict ``b`` (returns new dict)."""
    b = copy.deepcopy(b)
    for k, v in a.items():
        if isinstance(v, dict) and k in b and not v.pop(DELETE_KEY, False):
            if not isinstance(b[k], dict):
                raise TypeError(
                    f"Cannot merge dict into non-dict for key '{k}' ({type(b[k])}); "
                    f"add `{DELETE_KEY}=True` to replace the base value"
                )
            b[k] = _merge_a_into_b(v, b[k])
        else:
            if isinstance(v, dict):
                v = copy.deepcopy(v)
                v.pop(DELETE_KEY, None)
            b[k] = v
    return b


def _file_to_dict(filename: str) -> Dict[str, Any]:
    filename = osp.abspath(osp.expanduser(filename))
    ext = osp.splitext(filename)[1]
    if ext == ".py":
        cfg_dict = _load_py_file(filename)
    elif ext == ".json":
        with open(filename) as f:
            cfg_dict = json.load(f)
    elif ext in (".yml", ".yaml"):
        import yaml

        with open(filename) as f:
            cfg_dict = yaml.safe_load(f)
    else:
        raise OSError(f"Only .py/.json/.yml/.yaml configs are supported, got {filename}")

    base = cfg_dict.pop(BASE_KEY, None)
    if base is not None:
        base_files = base if isinstance(base, (list, tuple)) else [base]
        merged: Dict[str, Any] = {}
        for bf in base_files:
            parent = _file_to_dict(osp.join(osp.dirname(filename), bf))
            dup = set(merged) & set(parent)
            if dup:
                raise KeyError(f"Duplicate keys between _base_ files: {dup}")
            merged.update(parent)
        cfg_dict = _merge_a_into_b(cfg_dict, merged)
    return cfg_dict


class Config:
    """A nested configuration with attribute access and file provenance."""

    def __init__(self, cfg_dict: Optional[dict] = None, filename: Optional[str] = None):
        if cfg_dict is None:
            cfg_dict = {}
        if not isinstance(cfg_dict, dict):
            raise TypeError(f"cfg_dict must be a dict, got {type(cfg_dict)}")
        for key in cfg_dict:
            if key in RESERVED_KEYS:
                raise KeyError(f"{key} is reserved for Config internals")
        super().__setattr__("_cfg_dict", ConfigDict.convert(cfg_dict))
        super().__setattr__("_filename", filename)

    # -- constructors ------------------------------------------------------
    @staticmethod
    def fromfile(filename: str) -> "Config":
        return Config(_file_to_dict(filename), filename=filename)

    @staticmethod
    def from_dict(d: dict) -> "Config":
        return Config(copy.deepcopy(d))

    # -- mapping protocol ---------------------------------------------------
    @property
    def filename(self) -> Optional[str]:
        return self._filename

    def __getattr__(self, name: str) -> Any:
        return getattr(self._cfg_dict, name)

    def __setattr__(self, name: str, value: Any) -> None:
        self._cfg_dict[name] = ConfigDict.convert(value)

    def __getitem__(self, name: str) -> Any:
        return self._cfg_dict[name]

    def __setitem__(self, name: str, value: Any) -> None:
        self._cfg_dict[name] = ConfigDict.convert(value)

    def __contains__(self, name: str) -> bool:
        return name in self._cfg_dict

    def __iter__(self):
        return iter(self._cfg_dict)

    def __len__(self) -> int:
        return len(self._cfg_dict)

    def __repr__(self) -> str:
        return f"Config (path: {self._filename}): {self._cfg_dict!r}"

    def get(self, key: str, default: Any = None) -> Any:
        return self._cfg_dict.get(key, default)

    def pop(self, key: str, *default) -> Any:
        return self._cfg_dict.pop(key, *default)

    def setdefault(self, key: str, default: Any) -> Any:
        return self._cfg_dict.setdefault(key, ConfigDict.convert(default))

    def keys(self):
        return self._cfg_dict.keys()

    def items(self):
        return self._cfg_dict.items()

    def values(self):
        return self._cfg_dict.values()

    def to_dict(self) -> dict:
        def _plain(o):
            if isinstance(o, dict):
                return {k: _plain(v) for k, v in o.items()}
            if isinstance(o, (list, tuple)):
                return type(o)(_plain(v) for v in o)
            return o

        return _plain(self._cfg_dict)

    def copy(self) -> "Config":
        return Config(copy.deepcopy(self.to_dict()), filename=self._filename)

    # -- mutation -----------------------------------------------------------
    def merge_from_dict(self, options: Dict[str, Any]) -> None:
        """Apply ``{"a.b.c": v}`` style overrides (CLI --cfg-options)."""
        nested: Dict[str, Any] = {}
        for full_key, v in options.items():
            d = nested
            parts = full_key.split(".")
            for key in parts[:-1]:
                d = d.setdefault(key, {})
            d[parts[-1]] = v
        merged = _merge_a_into_b(nested, self.to_dict())
        super().__setattr__("_cfg_dict", ConfigDict.convert(merged))

    # -- dumping ------------------------------------------------------------
    @property
    def pretty_text(self) -> str:
        def _fmt(obj, indent=0) -> str:
            pad = " " * indent
            if isinstance(obj, dict):
                items = []
                for k, v in obj.items():
                    key = k if isinstance(k, str) and k.isidentifier() else repr(k)
                    items.append(f"{pad}    {key}={_fmt(v, indent + 4).lstrip()},")
                inner = "\n".join(items)
                return f"{pad}dict(\n{inner}\n{pad})"
            return pad + repr(obj)

        lines = []
        for k, v in self._cfg_dict.items():
            lines.append(f"{k} = {_fmt(v).lstrip() if isinstance(v, dict) else repr(v)}")
        return "\n".join(lines) + "\n"

    def dump(self, file: Optional[str] = None) -> Optional[str]:
        text = self.pretty_text
        if file is None:
            return text
        os.makedirs(osp.dirname(osp.abspath(file)), exist_ok=True)
        with open(file, "w") as f:
            f.write(text)
        return None


class DictAction(argparse.Action):
    """argparse action parsing ``KEY=VALUE`` pairs with typed values.

    Values are parsed with ``ast.literal_eval`` when possible, recognizing
    numbers, booleans, None, and nested tuples/lists; otherwise kept as str.
    """

    @staticmethod
    def _parse_value(value: str) -> Any:
        lowered = value.lower()
        if lowered in ("true", "false"):
            return lowered == "true"
        if lowered in ("none", "null"):
            return None
        try:
            return ast.literal_eval(value)
        except (ValueError, SyntaxError):
            return value

    def __call__(self, parser, namespace, values, option_string=None):
        options = getattr(namespace, self.dest, None) or {}
        for kv in values:
            key, sep, value = kv.partition("=")
            if not sep:
                raise ValueError(f"Override '{kv}' is not of the form KEY=VALUE")
            options[key] = self._parse_value(value)
        setattr(namespace, self.dest, options)
