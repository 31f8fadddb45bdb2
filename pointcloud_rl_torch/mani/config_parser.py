# Copy of pointcloud_rl_tpu/mani/config_parser.py for the PyTorch port, which imports nothing of that package; `import yaml` moves into load_task_config, so the package imports without PyYAML.
"""YAML task-spec pipeline for manipulation benchmarks.

Parity target: reference ``mani_skill/mani_skill/utils/config_parser.py`` —
three passes over a task YAML:

1. ``load_task_config`` (reference ``preprocess``): resolve ``file``/
   ``*_file`` paths relative to the YAML, then recursively splice
   ``_include`` sub-documents (include keys must not collide) and apply
   ``_override`` patches on top of what was included.
2. ``process_variables``: ``$name``-scoped variables — a dict may define
   ``$x: <expr>`` keys consumed by its subtree; string leaves may be plain
   values, ``eval(...)`` expressions, ``Uniform(lo, hi)`` /
   ``RandomAngleAxis(lo, hi, axis)`` samplers, or ``$x``-interpolated
   expressions.
3. ``process_variants``: ``_variants: {type: options, global_id, options}``
   nodes resolve to one sampled (or pinned via ``variant_config``) option —
   this is how a reset samples the PartNet-Mobility model for the level.

Sampling is driven by a caller-supplied ``np.random.RandomState`` so a level
seed fully determines the resolved scene.  Quaternion helpers come from
``.geometry`` (numpy wxyz), not transforms3d.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .geometry import axangle2quat, euler2quat, qmult

_VAR_PATTERN = re.compile(r"(\$[a-zA-Z_][a-zA-Z_0-9]*)")


class Rotation:
    """wxyz quaternion with ``*`` composition, for YAML rotation exprs."""

    def __init__(self, q):
        self.quat = np.asarray(q, np.float64)

    def __mul__(self, other: "Rotation") -> "Rotation":
        return Rotation(qmult(self.quat, other.quat))

    def to_quat(self) -> np.ndarray:
        return self.quat


def quat(q) -> Rotation:
    q = np.asarray(q, np.float64)
    return Rotation(q / np.linalg.norm(q))


def euler(xyz) -> Rotation:
    return Rotation(euler2quat(*xyz))


def angle_axis(angle: float, axis) -> Rotation:
    return Rotation(axangle2quat(axis, angle))


def _walk_dicts(node, fn) -> None:
    """Apply ``fn`` to every dict in the tree (pre-order)."""
    if isinstance(node, dict):
        fn(node)
        for v in node.values():
            _walk_dicts(v, fn)
    elif isinstance(node, list):
        for v in node:
            _walk_dicts(v, fn)


def load_task_config(filename) -> dict:
    """Load a task YAML, resolving file paths and ``_include``/``_override``."""
    import yaml

    path = Path(filename).resolve()
    with path.open("r") as f:
        cfg = yaml.safe_load(f)

    def resolve_files(d):
        for key, val in d.items():
            if key == "file" or key.endswith("_file"):
                assert isinstance(val, str), f"{key} must be a path string"
                d[key] = str((path.parent / val).resolve())

    _walk_dicts(cfg, resolve_files)

    includes = []
    _walk_dicts(cfg, lambda d: includes.append(d) if "_include" in d else None)
    # Splice deepest-first so nested includes inside included content resolve.
    for node in reversed(includes):
        included = load_task_config(path.parent / node["_include"])
        assert isinstance(included, dict), "_include must point at a mapping document"
        for key, val in included.items():
            assert key not in node, f"include key collision: {key}"
            node[key] = val
        del node["_include"]
        if "_override" in node:
            for key, val in node["_override"].items():
                assert key in included, f"_override key {key} not in included document"
                node[key] = val
            del node["_override"]
    return cfg


def _eval_leaf(leaf: str, rng: np.random.RandomState, scope: Dict[str, Any]):
    """Evaluate a string leaf: $-interpolation, eval(...), or samplers."""
    # YAML booleans sometimes arrive as bare words inside eval expressions
    env = {
        "true": True,
        "false": False,
        "Uniform": lambda lo, hi: rng.uniform(lo, hi),
        "RandomAngleAxis": lambda lo, hi, axis: angle_axis(rng.uniform(lo, hi), axis),
        "quat": quat,
        "euler": euler,
        "angleAxis": angle_axis,
        "np": np,
    }
    if "$" in leaf and not (leaf.startswith("eval(") and leaf.endswith(")")):
        expr = leaf
    elif leaf.startswith("eval(") and leaf.endswith(")"):
        expr = leaf[5:-1]
    elif leaf.startswith("Uniform") or leaf.startswith("RandomAngleAxis"):
        expr = leaf
    else:
        return leaf
    parts = [p for p in _VAR_PATTERN.split(expr) if p]
    if len(parts) == 1:
        if parts[0].startswith("$"):
            return scope[parts[0]]
        return eval(parts[0], env)  # noqa: S307 — task YAMLs are trusted config
    substituted = "".join(json.dumps(scope[p]) if p.startswith("$") else p for p in parts)
    return eval(substituted, env)  # noqa: S307


def _eval_scoped(node, rng: np.random.RandomState, scope: Dict[str, Any]):
    if isinstance(node, dict):
        local = dict(scope)
        for key in [k for k in node if k.startswith("$")]:
            local[key] = _eval_scoped(node.pop(key), rng, scope)
        for key in node:
            node[key] = _eval_scoped(node[key], rng, local)
        return node
    if isinstance(node, list):
        return [_eval_scoped(v, rng, scope) for v in node]
    if isinstance(node, str):
        return _eval_leaf(node, rng, scope)
    return node


def process_variables(cfg, rng: np.random.RandomState):
    """Resolve ``$var`` scopes, eval() expressions, and samplers in place."""
    return _eval_scoped(cfg, rng, {})


def _resolve_variants(node, rng, variant_config: Dict[str, Any], chosen: Dict[str, Any]):
    if isinstance(node, dict):
        if "_variants" in node:
            var = node["_variants"]
            assert var["type"] == "options", f"unsupported variant type {var['type']}"
            gid = var["global_id"]
            options = var["options"]
            keys = list(options.keys())
            if gid in variant_config:
                idx = keys.index(variant_config[gid])
            else:
                idx = int(rng.choice(len(keys)))
            key = keys[idx]
            value = options[key]
            chosen[gid] = {"type": "options", "key": key, "index": idx}
            if isinstance(value, dict):
                node.update(value)
                del node["_variants"]
            else:
                assert len(node) == 1, "a scalar variant's parent must hold only _variants"
                return value
        for k in node:
            node[k] = _resolve_variants(node[k], rng, variant_config, chosen)
        return node
    if isinstance(node, list):
        return [_resolve_variants(v, rng, variant_config, chosen) for v in node]
    return node


def process_variants(cfg, rng: np.random.RandomState,
                     variant_config: Optional[Dict[str, Any]] = None) -> Tuple[Any, Dict[str, Any]]:
    """Resolve ``_variants`` option nodes; returns (config, chosen options).

    ``variant_config`` pins options by global_id (e.g. a fixed cabinet model
    for an eval level); unpinned options are sampled from ``rng``.
    """
    chosen: Dict[str, Any] = {}
    cfg = _resolve_variants(cfg, rng, variant_config or {}, chosen)
    return cfg, chosen
