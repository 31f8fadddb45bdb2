# Copy of pointcloud_rl_tpu/utils/io.py (FileCache.close also joins its thread) for the PyTorch port, which imports nothing of that package.
"""File I/O: format-dispatched (de)serialization, tree<->HDF5, compression.

Covers the reference's pyrl/utils/file core (serialization handlers,
hdf5_utils GDict serialization, compression.py DataCoder): load/dump by
extension, nested-tree HDF5 round trips, and replay-oriented codecs
(float16 quantization, PNG-encoded rgb via cv2).
"""

from __future__ import annotations

import csv
import json
import os
import os.path as osp
import pickle
from typing import Any, Dict, List, Optional

import numpy as np


# ------------------------------------------------------------- serialization
def load(path: str, **kwargs) -> Any:
    ext = osp.splitext(path)[1].lower()
    if ext in (".pkl", ".pickle"):
        with open(path, "rb") as f:
            return pickle.load(f)
    if ext == ".json":
        with open(path) as f:
            return json.load(f)
    if ext in (".yml", ".yaml"):
        import yaml

        with open(path) as f:
            return yaml.safe_load(f)
    if ext == ".csv":
        with open(path, newline="") as f:
            return list(csv.DictReader(f))
    if ext == ".txt":
        with open(path) as f:
            return f.read()
    if ext == ".npy":
        return np.load(path, allow_pickle=False)
    if ext in (".h5", ".hdf5"):
        return load_hdf5(path)
    raise KeyError(f"Unsupported extension {ext}")


def dump(obj: Any, path: str, **kwargs) -> None:
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    ext = osp.splitext(path)[1].lower()
    if ext in (".pkl", ".pickle"):
        with open(path, "wb") as f:
            pickle.dump(obj, f)
    elif ext == ".json":
        with open(path, "w") as f:
            json.dump(obj, f, indent=2, default=str)
    elif ext in (".yml", ".yaml"):
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(obj, f)
    elif ext == ".csv":
        assert isinstance(obj, (list, tuple)) and obj and isinstance(obj[0], dict)
        with open(path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(obj[0]))
            writer.writeheader()
            writer.writerows(obj)
    elif ext == ".txt":
        with open(path, "w") as f:
            f.write(str(obj))
    elif ext == ".npy":
        np.save(path, obj)
    elif ext in (".h5", ".hdf5"):
        dump_hdf5(obj, path)
    else:
        raise KeyError(f"Unsupported extension {ext}")


# -------------------------------------------------------------------- hdf5
def dump_hdf5(tree, path: str, compression: Optional[str] = "gzip") -> None:
    import h5py

    with h5py.File(path, "w") as f:

        def _walk(group, node):
            for k, v in node.items():
                if isinstance(v, dict):
                    _walk(group.create_group(str(k)), v)
                else:
                    arr = np.asarray(v)
                    kwargs = {"compression": compression} if (compression and arr.ndim > 0) else {}
                    group.create_dataset(str(k), data=arr, **kwargs)

        _walk(f, tree if isinstance(tree, dict) else {"data": tree})


def load_hdf5(path: str):
    import h5py

    with h5py.File(path, "r") as f:

        def _walk(group):
            return {k: (_walk(v) if hasattr(v, "items") else np.asarray(v)) for k, v in group.items()}

        out = _walk(f)
    return out["data"] if list(out) == ["data"] else out


# -------------------------------------------------------------- compression
def float_to_int(data: np.ndarray, vrange=(0.0, 1.0), res=None, dtype="uint8") -> np.ndarray:
    """Quantize floats into an integer dtype (reference compression.py:9-26):
    either affinely over ``vrange`` across the full integer range, or by a
    fixed resolution ``res`` (value / res, e.g. xyz at 1 mm -> int16)."""
    data = np.asarray(data)
    if data.dtype.kind in "iu":
        return data.astype(dtype)
    info = np.iinfo(np.dtype(dtype))
    if vrange is not None:
        assert res is None and vrange[0] < vrange[1]
        x = (np.clip(data, vrange[0], vrange[1]) - vrange[0]) / (vrange[1] - vrange[0])
        x = x * info.max + (1 - x) * info.min
    else:
        assert res is not None
        x = data / res
    return np.clip(x, info.min, info.max).astype(dtype)


def int_to_float(data: np.ndarray, vrange=(0.0, 1.0), res=None) -> np.ndarray:
    """Inverse of float_to_int (reference compression.py:28-49)."""
    data = np.asarray(data)
    if data.dtype.kind == "f":
        return data.astype(np.float32)
    info = np.iinfo(data.dtype)
    if vrange is not None:
        assert res is None
        x = (data.astype(np.float32) - np.float32(info.min)) / (np.float32(info.max) - np.float32(info.min))
        x = x * np.float32(vrange[1]) + (1 - x) * np.float32(vrange[0])
    else:
        assert res is not None
        x = data * np.float32(res)
    return x.astype(np.float32)


def _imencode_png(img: np.ndarray) -> bytes:
    import cv2

    ok, buf = cv2.imencode(".png", img)
    assert ok, f"PNG encode failed for shape {img.shape} dtype {img.dtype}"
    return buf.tobytes()


def _imdecode_png(data) -> np.ndarray:
    import cv2

    return cv2.imdecode(np.frombuffer(bytes(data), np.uint8), cv2.IMREAD_UNCHANGED)


class DataCoder:
    """Replay/trajectory codecs (reference compression.py:70-196 role):

    * float32 -> float16 ("f16") for xyz/depth-like channels
    * "quantize": float <-> int range/resolution quantization (np_compress)
    * per-image codecs for trajectory files:
      - uint8 rgb PNG ("rgb_png", [H, W, 3k] uint8)
      - uint16 depth PNG ("depth_png", [H, W, k] uint16 — PNG natively
        stores 16-bit grayscale)
      - segmentation-mask PNG ("seg_png", [H, W, m<=7] bool bit-packed into
        one uint8 image with a sentinel bit marking the mask count)

    ``compress_cfg``: {key: (op, *args)} applied per top-level key by
    encode()/decode(); image codecs operate on single frames via
    encode_image/decode_image (variable-length bytes, stored as vlen
    datasets in HDF5 trajectories).
    """

    def __init__(self, f16: bool = True, png_keys: tuple = ("rgb",),
                 compress_cfg: Optional[dict] = None):
        self.f16 = f16
        self.png_keys = png_keys
        self.compress_cfg = dict(compress_cfg or {})

    def _apply_key(self, key: str, x: np.ndarray, encode: bool) -> np.ndarray:
        op, *args = self.compress_cfg[key] if isinstance(self.compress_cfg[key], (tuple, list)) \
            else (self.compress_cfg[key],)
        if op == "quantize":
            return float_to_int(x, *args) if encode else int_to_float(x, *[a for a in args[:2]])
        raise KeyError(f"unknown codec op {op!r} for key {key!r}")

    def encode(self, tree):
        from .tree_ops import tree_map

        if isinstance(tree, dict) and self.compress_cfg:
            tree = {k: (self._apply_key(k, v, True) if k in self.compress_cfg else v)
                    for k, v in tree.items()}

        def _enc(x):
            x = np.asarray(x)
            if self.f16 and x.dtype == np.float32:
                return x.astype(np.float16)
            return x

        return tree_map(_enc, tree)

    def decode(self, tree):
        from .tree_ops import tree_map

        def _dec(x):
            x = np.asarray(x)
            if x.dtype == np.float16:
                return x.astype(np.float32)
            return x

        tree = tree_map(_dec, tree)
        if isinstance(tree, dict) and self.compress_cfg:
            tree = {k: (self._apply_key(k, v, False) if k in self.compress_cfg else v)
                    for k, v in tree.items()}
        return tree

    # ------------------------------------------------- per-image PNG codecs
    @staticmethod
    def encode_png(img: np.ndarray) -> bytes:
        return _imencode_png(img)

    @staticmethod
    def decode_png(data: bytes) -> np.ndarray:
        return _imdecode_png(data)

    @staticmethod
    def encode_depth_png(depth: np.ndarray) -> bytes:
        """[H, W] or [H, W, 1] uint16 depth -> 16-bit grayscale PNG
        (reference uint16_png, compression.py:133-142)."""
        assert depth.dtype == np.uint16, "depth must be pre-quantized to uint16"
        return _imencode_png(depth.reshape(depth.shape[0], depth.shape[1]))

    @staticmethod
    def decode_depth_png(data: bytes) -> np.ndarray:
        return _imdecode_png(data).astype(np.uint16)

    @staticmethod
    def encode_seg_png(seg: np.ndarray) -> bytes:
        """[H, W, m] bool masks (m <= 7) bit-packed little-endian into one
        uint8 image; an always-on sentinel bit above the masks encodes m so
        decode recovers the mask count (reference seg_png,
        compression.py:144-156)."""
        assert seg.ndim == 3 and seg.shape[-1] <= 7, "at most 7 masks per packed image"
        packed = np.packbits(
            np.concatenate([seg.astype(bool), np.ones_like(seg[..., :1], bool)], axis=-1),
            axis=-1, bitorder="little",
        )[..., 0]
        return _imencode_png(packed)

    @staticmethod
    def decode_seg_png(data: bytes) -> np.ndarray:
        packed = _imdecode_png(data)
        num_segs = int(packed[0, 0]).bit_length() - 1
        return np.unpackbits(packed[..., None], axis=-1, count=num_segs, bitorder="little").astype(bool)


# --------------------------------------------------------------- file cache
class FileCache:
    """Background prefetcher for trajectory files (reference cache_utils.py
    role, thread-based): keeps up to ``ahead`` decoded files ready while the
    consumer trains — used when the replay capacity is smaller than the
    dataset and files are streamed in shards.

    ``close`` stops the thread and joins it, so that no loader runs on while
    the interpreter shuts down."""

    def __init__(self, filenames: List[str], loader=load, ahead: int = 2, loop: bool = True):
        import queue
        import threading

        self.filenames = list(filenames)
        self.loader = loader
        self.loop = loop
        self._q: "queue.Queue" = queue.Queue(maxsize=max(ahead, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item) -> None:
        import queue

        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def _run(self):
        i = 0
        while not self._stop.is_set() and (self.loop or i < len(self.filenames)):
            path = self.filenames[i % len(self.filenames)]
            try:
                data = self.loader(path)
            except Exception as e:  # surface loader failures to the consumer
                data = e
            self._put((path, data))
            i += 1
        self._put((None, None))

    def get(self, timeout: Optional[float] = 60.0):
        """(path, data) of the next prefetched file; raises loader errors."""
        path, data = self._q.get(timeout=timeout)
        if isinstance(data, Exception):
            raise data
        return path, data

    def close(self):
        import queue

        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(10.0)
