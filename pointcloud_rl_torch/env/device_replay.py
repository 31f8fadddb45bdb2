"""Device-resident replay buffer with on-device sampling.

Port of ``pointcloud_rl_tpu/env/device_replay.py``.  Transitions are
uploaded once, at push (a few rows per env step), into ring storage of
``[capacity, ...]`` tensors on an explicit device; a training batch is a
gather there, with indices drawn from a ``torch.Generator`` on the same
device, so an update moves no batch from the host and waits on no copy.

``transfer_cfg.pack_features`` (``True`` for bf16, or a dtype name) stores
each observation as the model-input tensor (``pack_device_features``:
``{"pcd": [N, C], "state"}``): the pos_encoding block, when the obs have
one, is stripped before upload and re-synthesized on the device.  At 1200
points x 8 channels in bf16 that is 19.2 KB per observation.

``tail`` (the snapshot ``train_rl``'s ``save_replay`` writes), ``get_all``
and ``to_hdf5`` gather to the host in chunks of rows; ``load_hdf5`` pushes
a snapshot back in chunks as it reads them (``push_in_chunks``).

This module imports torch; the rest of ``pointcloud_rl_torch.env`` does
not, and ``build_replay`` imports it only for a ``DeviceReplayMemory``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..utils.tree_ops import first_leaf, tree_map
from .builder import REPLAYS
from .replay import ReplayMemory, apply_transfer

_SKIP_KEYS = ("infos",)
# Rows per gather of ``tail`` / ``get_all`` and per push of a restore: the
# device holds one chunk's copy at most (50000 rows of the walker's packed
# storage are 2.8 GB).  ``load_hdf5``'s default, as in the JAX package.
CHUNK = 4096


def _storage_dtype(spec) -> torch.dtype:
    if spec is True:
        return torch.bfloat16
    dtype = getattr(torch, str(spec), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"pack_features={spec!r}: expected True or a torch dtype name")
    return dtype


@REPLAYS.register_module()
class DeviceReplayMemory:
    """The host ``ReplayMemory``'s interface where the training loop touches it."""

    def __init__(self, capacity: int, sampling_cfg: Optional[dict] = None, keys: Optional[List[str]] = None,
                 seed: Optional[int] = None, transfer_cfg: Optional[dict] = None, device="cuda", **kwargs):
        self.capacity = int(capacity)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DeviceReplayMemory on 'cuda' was asked for, but torch.cuda.is_available() is false")
        self.storage: Optional[Dict[str, Any]] = None  # tree of [capacity, ...] tensors, made at the first push
        self.position = 0
        self.running_count = 0
        self.keys = keys
        self.transfer_cfg = dict(transfer_cfg) if transfer_cfg else None
        self._pack_dtype: Optional[torch.dtype] = None
        if self.transfer_cfg and self.transfer_cfg.get("pack_features"):
            self._pack_dtype = _storage_dtype(self.transfer_cfg.pop("pack_features"))
            if not self.transfer_cfg:
                self.transfer_cfg = None
        self._synth_pos = None  # (rows, points per frame) of a stripped pos_encoding
        self.seed = int(seed or 0)
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self._traj_cache: Dict[int, list] = {}

    def __len__(self) -> int:
        return min(self.running_count, self.capacity)

    def reset(self) -> None:
        self.position = 0
        self.running_count = 0

    # ----------------------------------------------------------------- push
    def _clean(self, items: Dict[str, Any]) -> Dict[str, Any]:
        items = {k: v for k, v in items.items() if k not in _SKIP_KEYS}
        if self.keys is not None:
            items = {k: v for k, v in items.items() if k in self.keys}
        return apply_transfer(items, self.transfer_cfg)

    def _upload(self, tree):
        def _one(x):
            return (x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))).to(self.device)

        return tree_map(_one, tree)

    def _pack(self, items: Dict[str, Any]) -> Dict[str, Any]:
        """Strip pos_encoding on the host, upload, pack on the device.  Obs
        that are packed already (a snapshot's) pass through."""
        from ..algorithms.obs_transfer import pack_device_features

        if self.storage is None:  # the first push fixes the block's shape
            obs = items.get("obs")
            if isinstance(obs, dict) and "pos_encoding" in obs:
                rows, n = (int(s) for s in np.shape(obs["pos_encoding"])[-2:])
                if n % rows == 0:
                    self._synth_pos = (rows, n // rows)
        items = dict(items)
        for key in ("obs", "next_obs"):
            o = items.get(key)
            if isinstance(o, dict) and "xyz" in o:
                if self._synth_pos is not None:
                    o = {k: v for k, v in o.items() if k != "pos_encoding"}
                items[key] = pack_device_features(self._upload(o), self._pack_dtype, synth_pos=self._synth_pos)
        return self._upload(items)

    def _write(self, start: int, batch) -> None:
        def _copy(dst, src):
            dst[start:start + len(src)].copy_(src)

        tree_map(_copy, self.storage, batch)

    def push_batch(self, items: Dict[str, Any]) -> None:
        items = self._clean(items)
        items = self._pack(items) if self._pack_dtype is not None else self._upload(items)
        batch = len(first_leaf(items))
        if batch > self.capacity:
            items = tree_map(lambda x: x[: self.capacity], items)
            batch = self.capacity
        if self.storage is None:
            self.storage = tree_map(
                lambda x: torch.zeros((self.capacity,) + tuple(x.shape[1:]), dtype=x.dtype, device=self.device),
                items)
        end = self.position + batch
        if end <= self.capacity:
            self._write(self.position, items)
        else:  # split at the wraparound
            first = self.capacity - self.position
            self._write(self.position, tree_map(lambda x: x[:first], items))
            self._write(0, tree_map(lambda x: x[first:], items))
        self.position = end % self.capacity
        self.running_count += batch

    # full-episode trajectory caching is the host replay's
    def cache_trajectories(self, items, max_push: int = -1) -> int:
        return ReplayMemory.cache_trajectories(self, items, max_push)

    def push_cached_trajectories(self, max_push: int = -1) -> int:
        return ReplayMemory.push_cached_trajectories(self, max_push)

    # --------------------------------------------------------------- sample
    def _draw_indices(self, batch_size: int) -> torch.Tensor:
        return torch.randint(0, len(self), (batch_size,), generator=self.generator, device=self.device)

    def gather(self, idx: torch.Tensor) -> Dict[str, Any]:
        """The rows ``idx`` (a tensor on the storage's device) of every leaf."""
        return tree_map(lambda s: s.index_select(0, idx), self.storage)

    def sample(self, batch_size: int) -> Dict[str, Any]:
        """A batch of tensors on the storage's device; no host round trip."""
        if len(self) == 0:
            raise ValueError("Cannot sample from an empty buffer")
        return self.gather(self._draw_indices(batch_size))

    def _rows_to_host(self, idx: torch.Tensor) -> Dict[str, Any]:
        """The rows ``idx`` of every leaf as CPU tensors, gathered ``CHUNK``
        rows at a time."""
        n = len(idx)
        out = tree_map(lambda s: torch.empty((n,) + tuple(s.shape[1:]), dtype=s.dtype), self.storage)
        for start in range(0, n, CHUNK):
            part = self.gather(idx[start:start + CHUNK])
            tree_map(lambda dst, src: dst[start:start + len(src)].copy_(src), out, part)
        return out

    def tail(self, num: int) -> Dict[str, Any]:
        """The most recent ``num`` transitions in push order, as CPU tensors."""
        num = min(num, len(self))
        idx = torch.as_tensor(np.arange(self.position - num, self.position) % self.capacity, device=self.device)
        return self._rows_to_host(idx)

    def get_all(self) -> Dict[str, Any]:
        """Every stored transition in storage order (not push order, once
        the ring has wrapped), as CPU tensors."""
        return self._rows_to_host(torch.arange(len(self), device=self.device))

    def to_hdf5(self, filename: str) -> None:
        """``get_all()`` written by a host ``ReplayMemory`` (bfloat16 leaves
        as tagged uint16 bits, ``replay.h5_storable``)."""
        host = ReplayMemory(len(self))
        host.push_batch(self.get_all())
        host.to_hdf5(filename)

    def push_in_chunks(self, n: int, rows, chunk: int = CHUNK) -> None:
        """Push ``n`` transitions in order, ``chunk`` rows at a time;
        ``rows(sl)`` gives those of the slice ``sl`` (of a file being read,
        or of a host tree).  Fixed-size chunks bound the host and device
        temporaries of a large restore.  A packed snapshot's obs
        (``{"pcd", "state"}``) are stored as they are: ``_pack`` packs only
        an obs dict with ``xyz``."""
        for start in range(0, n, chunk):
            self.push_batch(rows(slice(start, min(start + chunk, n))))

    def load_hdf5(self, filename: str, chunk: int = CHUNK) -> None:
        """Push a snapshot (``to_hdf5``, or a host replay's) in ``chunk``-row
        pieces as they are read."""
        import h5py

        from .replay import h5_read

        def _load(group, sl):
            return {k: (_load(v, sl) if hasattr(v, "items") else h5_read(v, sl)) for k, v in group.items()}

        def _first_ds(group):
            for v in group.values():
                found = _first_ds(v) if hasattr(v, "items") else v
                if found is not None:
                    return found
            return None

        with h5py.File(filename, "r") as f:
            ds = _first_ds(f)
            self.push_in_chunks(0 if ds is None else len(ds), lambda sl: _load(f, sl), chunk)

    def place_on(self, device) -> None:
        """Keep this replica on ``device``, a data-parallel rank's own
        (``parallel.setup_data_parallel``).  Every rank holds a replica with
        the same seed and the same pushes, so all draw the same indices:
        the JAX package's replicated storage, at N times the memory.  A
        move to another device starts the index stream anew from the seed,
        so it is made before the first sample."""
        device = torch.device(device)
        if device == self.device:
            return
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"place_on({device}): torch.cuda.is_available() is false")
        self.device = device
        if self.storage is not None:
            self.storage = tree_map(lambda x: x.to(device), self.storage)
        self.generator = torch.Generator(device=device).manual_seed(self.seed)
