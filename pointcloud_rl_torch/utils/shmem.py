# Copy of pointcloud_rl_tpu/utils/shmem.py for the PyTorch port, which imports nothing of that package.
"""Shared-memory tree buffers for zero-copy env-worker -> trainer transport.

Parity target: the reference's obs plane (SharedGDict/SharedDictArray,
dict_array.py:872-972 + BufferAugmentedEnv, wrappers.py:27-52): each env
worker writes its observation into its slice of a POSIX shared-memory
buffer; the trainer reads all slices without pickling or pipe copies.

A buffer is described by a picklable meta tree of (shm_name, shape, dtype)
triples; workers attach by name after fork/spawn.
"""

from __future__ import annotations

from multiprocessing import shared_memory
from typing import Any, Dict, List, Tuple

import numpy as np

from .tree_ops import tree_map


class SharedTreeBuffer:
    """Tree of numpy arrays living in shared memory, leading axis = slots."""

    def __init__(self, segments, views, meta, owner: bool):
        self._segments = segments  # list of SharedMemory handles
        self.tree = views  # tree of numpy views
        self.meta = meta  # picklable description
        self._owner = owner

    # -------------------------------------------------------------- create
    @classmethod
    def create(cls, example_tree, slots: int) -> "SharedTreeBuffer":
        segments: List[shared_memory.SharedMemory] = []

        def _alloc(x):
            x = np.asarray(x)
            shape = (slots,) + x.shape
            size = int(np.prod(shape)) * x.dtype.itemsize
            shm = shared_memory.SharedMemory(create=True, size=max(size, 1))
            segments.append(shm)
            view = np.ndarray(shape, dtype=x.dtype, buffer=shm.buf)
            view[:] = 0
            return (shm.name, shape, x.dtype.str), view

        metas, views = {}, {}

        def _walk(node, meta_out, view_out):
            for k, v in node.items():
                if isinstance(v, dict):
                    meta_out[k], view_out[k] = {}, {}
                    _walk(v, meta_out[k], view_out[k])
                else:
                    meta_out[k], view_out[k] = _alloc(v)

        if isinstance(example_tree, dict):
            _walk(example_tree, metas, views)
        else:
            metas, views = _alloc(example_tree)
        return cls(segments, views, metas, owner=True)

    # -------------------------------------------------------------- attach
    @classmethod
    def attach(cls, meta) -> "SharedTreeBuffer":
        segments: List[shared_memory.SharedMemory] = []

        def _open(m):
            name, shape, dtype = m
            # Only the creating process owns the segment lifetime: an
            # attaching child must not register with the resource tracker at
            # all (3.12 has no track= kwarg, and tracker processes are shared
            # across forkserver children, so a post-hoc unregister here would
            # erase the OWNER's registration and spew KeyErrors at exit).
            try:
                shm = shared_memory.SharedMemory(name=name, track=False)  # py>=3.13
            except TypeError:
                from multiprocessing import resource_tracker

                orig = resource_tracker.register
                resource_tracker.register = lambda *a, **k: None
                try:
                    shm = shared_memory.SharedMemory(name=name)
                finally:
                    resource_tracker.register = orig
            segments.append(shm)
            return np.ndarray(tuple(shape), dtype=np.dtype(dtype), buffer=shm.buf)

        def _walk(node):
            if isinstance(node, dict):
                return {k: _walk(v) for k, v in node.items()}
            return _open(node)

        return cls(segments, _walk(meta), meta, owner=False)

    # ----------------------------------------------------------------- ops
    def write(self, slot: int, tree) -> None:
        tree_map(lambda dst, src: dst.__setitem__(slot, src), self.tree, tree)

    def read(self, slot=None, copy: bool = True):
        index = slice(None) if slot is None else slot
        return tree_map(lambda x: x[index].copy() if copy else x[index], self.tree)

    def read_batch(self, slots) -> Any:
        """Stacked copy of several slots in one fancy-index per leaf —
        replaces N per-slot ``read`` copies + a tree_stack copy on the vec
        env's hot obs path (fancy indexing already materializes a copy)."""
        slots = np.asarray(slots)
        return tree_map(lambda x: x[slots], self.tree)

    def close(self) -> None:
        for shm in self._segments:
            try:
                shm.close()
                if self._owner:
                    shm.unlink()
            except FileNotFoundError:
                pass

    def __del__(self):  # best-effort cleanup
        try:
            self.close()
        except Exception:
            pass
