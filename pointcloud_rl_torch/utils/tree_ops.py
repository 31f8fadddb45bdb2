# Copy of pointcloud_rl_tpu/utils/tree_ops.py (the functions the port calls) for the PyTorch port, which imports nothing of that package.
"""Host-side operations on nested dict/list trees of numpy arrays.

This is the data currency of the framework: observations, replay transitions,
and shared-memory buffers are all nested dicts of numpy arrays ("trees").
It replaces the reference's GDict/DictArray (reference
``pyrl/utils/data/dict_array.py`` — whose own docstring suggests merging with
jax pytrees) with a minimal functional toolkit; on-device data uses jax
pytrees directly, so only the host-side subset is implemented here.

All functions treat dicts/lists/tuples as structure and everything else as a
leaf, and are non-mutating unless explicitly named ``assign``.
"""

from __future__ import annotations

import sys
from typing import Any, Callable, Dict, List, Sequence, Tuple, Union

import numpy as np

Tree = Union[Dict[str, Any], List[Any], Tuple[Any, ...], np.ndarray]


def tree_map(fn: Callable, *trees: Tree) -> Tree:
    """Apply ``fn`` to corresponding leaves of one or more trees."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *[t[k] for t in trees]) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def tree_leaves(tree: Tree) -> List[Any]:
    out: List[Any] = []

    def _walk(t):
        if isinstance(t, dict):
            for k in t:
                _walk(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                _walk(v)
        else:
            out.append(t)

    _walk(tree)
    return out


def first_leaf(tree: Tree) -> Any:
    if isinstance(tree, dict):
        return first_leaf(next(iter(tree.values())))
    if isinstance(tree, (list, tuple)):
        return first_leaf(tree[0])
    return tree


def batch_size(tree: Tree) -> int:
    """Length of the leading axis of every leaf (asserted consistent)."""
    leaves = tree_leaves(tree)
    n = len(leaves[0])
    assert all(len(l) == n for l in leaves), "Inconsistent leading axis in tree"
    return n


def f64_to_f32(tree: Tree) -> Tree:
    """Downcast float64->float32 and int64->int32 (reference ExtendedEnv semantics)."""

    def _conv(x):
        x = np.asarray(x)
        if x.dtype == np.float64:
            return x.astype(np.float32)
        if x.dtype == np.int64:
            return x.astype(np.int32)
        return x

    return tree_map(_conv, tree)


def tree_slice(tree: Tree, index) -> Tree:
    """Index the leading axis of every leaf (int, slice, or index array)."""
    return tree_map(lambda x: x[index], tree)


def is_tensor(x) -> bool:
    """Whether ``x`` is a torch tensor, without importing torch: a process
    that never imported it holds none.  A host tree may hold CPU tensors
    where numpy has no dtype for the data (bfloat16)."""
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


def tree_take(tree: Tree, indices: np.ndarray, axis: int = 0) -> Tree:
    def _take(x):
        if is_tensor(x):
            import torch

            return x.index_select(axis, torch.as_tensor(np.asarray(indices, np.int64)))
        return np.take(x, indices, axis=axis)

    return tree_map(_take, tree)


def tree_concat(trees: Sequence[Tree], axis: int = 0) -> Tree:
    return tree_map(lambda *xs: np.concatenate(xs, axis=axis), *trees)


def tree_stack(trees: Sequence[Tree], axis: int = 0) -> Tree:
    return tree_map(lambda *xs: np.stack(xs, axis=axis), *trees)


def tree_expand(tree: Tree, axis: int = 0) -> Tree:
    return tree_map(lambda x: np.expand_dims(x, axis), tree)


def tree_assign(dst: Tree, index, src: Tree) -> None:
    """In-place assignment ``dst[leaf][index] = src[leaf]`` for every leaf."""

    def _asn(d, s):
        d[index] = s

    tree_map(_asn, dst, src)


def tree_empty_like_with_capacity(tree: Tree, capacity: int, batched: bool = True) -> Tree:
    """Preallocate ``[capacity, *leaf.shape[batched:]]`` arrays matching dtypes."""

    def _alloc(x):
        inner = tuple(np.shape(x)[1:] if batched else np.shape(x))
        if is_tensor(x):
            return x.new_empty((capacity,) + inner)
        return np.empty((capacity,) + inner, dtype=np.asarray(x).dtype)

    return tree_map(_alloc, tree)


def tree_shape(tree: Tree) -> Tree:
    return tree_map(lambda x: tuple(np.asarray(x).shape), tree)


def dict_to_str(d: Dict[str, Any], precision: int = 3) -> str:
    """Render a flat metrics dict as ``k1: v1, k2: v2`` with numeric rounding."""
    parts = []
    for k, v in d.items():
        if isinstance(v, float):
            if v == 0:
                parts.append(f"{k}: 0")
            elif abs(v) >= 1e4 or abs(v) < 10 ** (-precision):
                parts.append(f"{k}: {v:.{precision}e}")
            else:
                parts.append(f"{k}: {round(v, precision)}")
        else:
            parts.append(f"{k}: {v}")
    return ", ".join(parts)
