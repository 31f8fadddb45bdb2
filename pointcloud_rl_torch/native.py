# Copy of pointcloud_rl_tpu/native.py for the PyTorch port, which imports nothing of that package.
"""ctypes bindings to the native host kernels (``csrc/pcrl_native.cpp``).

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
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.unproject_depth.argtypes = [f32p, ctypes.c_int32, ctypes.c_int32, f64p, f64p, ctypes.c_float, f32p]
        lib.unproject_depth.restype = None
        lib.ground_body_split_sample.argtypes = [
            f32p, u8p, u8p, ctypes.c_int32, ctypes.c_float, ctypes.c_float,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64, f32p, u8p,
        ]
        lib.ground_body_split_sample.restype = ctypes.c_int32
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


def unproject_depth(depth: np.ndarray, inv_intrinsic: np.ndarray, cam_rot: np.ndarray, z_offset: float) -> np.ndarray:
    lib = get_lib()
    h, w = depth.shape
    depth = np.ascontiguousarray(depth, np.float32)
    out = np.empty((h, w, 3), np.float32)
    lib.unproject_depth(
        _ptr(depth, ctypes.c_float), h, w,
        _ptr(np.ascontiguousarray(inv_intrinsic, np.float64), ctypes.c_double),
        _ptr(np.ascontiguousarray(cam_rot, np.float64), ctypes.c_double),
        ctypes.c_float(z_offset), _ptr(out, ctypes.c_float),
    )
    return out


def ground_body_split_sample(
    xyz: np.ndarray, rgb: np.ndarray, valid: Optional[np.ndarray],
    ground_eps: float, n_body: int, n_ground: int, seed: int,
    fix_base_z: Optional[float] = None,
):
    lib = get_lib()
    n = len(xyz)
    xyz = np.ascontiguousarray(xyz, np.float32)
    rgb = np.ascontiguousarray(rgb, np.uint8)
    valid_arr = np.ascontiguousarray(valid, np.uint8) if valid is not None else None
    out_xyz = np.empty((n_body + n_ground, 3), np.float32)
    out_rgb = np.empty((n_body + n_ground, 3), np.uint8)
    n_valid = lib.ground_body_split_sample(
        _ptr(xyz, ctypes.c_float), _ptr(rgb, ctypes.c_uint8),
        _ptr(valid_arr, ctypes.c_uint8) if valid_arr is not None else None,
        n, ctypes.c_float(ground_eps),
        ctypes.c_float(fix_base_z if fix_base_z is not None else 0.0),
        1 if fix_base_z is not None else 0,
        n_body, n_ground, ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF),
        _ptr(out_xyz, ctypes.c_float), _ptr(out_rgb, ctypes.c_uint8),
    )
    return out_xyz, out_rgb, int(n_valid)


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
