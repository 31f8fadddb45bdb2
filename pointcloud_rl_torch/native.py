# Copy of pointcloud_rl_tpu/native.py (``available`` and ``seg_balanced_sample_indices`` only) for the PyTorch port, which imports nothing of that package.
"""ctypes bindings to the native host kernel (``csrc/pcrl_native.cpp``).

Builds the shared library on first use (g++, cached under
``build/pointcloud_rl_torch/`` by ``ops/build.py``).  Where no host compiler
is available, ``available()`` is False and callers take the numpy path:
the native path is an optimization, not a requirement.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from typing import Optional

import numpy as np

from .ops import build

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            path = build.build_host_library("pcrl_native")
        except (RuntimeError, OSError, subprocess.SubprocessError):
            _build_failed = True
            return None
        lib = ctypes.CDLL(str(path))
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.seg_balanced_sample_indices.argtypes = [
            f32p, u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64, i32p,
        ]
        lib.seg_balanced_sample_indices.restype = ctypes.c_int32
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def seg_balanced_sample_indices(
    xyz: np.ndarray, seg: np.ndarray, n_points: int, min_pts: int, fg_pts: int, seed: int
) -> np.ndarray:
    lib = get_lib()
    n, k = seg.shape
    xyz = np.ascontiguousarray(xyz, np.float32)
    seg = np.ascontiguousarray(seg, np.uint8)
    out = np.empty(n_points, np.int32)
    lib.seg_balanced_sample_indices(
        _ptr(xyz, ctypes.c_float), _ptr(seg, ctypes.c_uint8), n, k,
        n_points, min_pts, fg_pts, ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF),
        _ptr(out, ctypes.c_int32),
    )
    return out
