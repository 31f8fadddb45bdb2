# Copy of pointcloud_rl_tpu/env/replay.py for the PyTorch port (that package's env imports JAX).
"""Replay memory: preallocated host ring buffer over transition trees.

Parity target: reference ``pyrl/env/replay_buffer.py`` — lazy allocation
from the first pushed batch, wraparound ``push_batch``, per-worker trajectory
caching for full-episode pushes, uniform sampling through a strategy object,
HDF5 import/export, and ``tail``/``get_all`` views.

Design note: the buffer lives in host RAM as numpy (env workers write it);
the update uploads sampled batches to its device.  A leaf may instead be a
torch CPU tensor where numpy has no dtype for it: bfloat16, as in a
snapshot of a packed ``DeviceReplayMemory`` (env/device_replay.py, the
variant that samples on the device).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..utils.trace import REPLAY_SAMPLE, span
from ..utils.tree_ops import (
    first_leaf,
    is_tensor,
    tree_assign,
    tree_concat,
    tree_empty_like_with_capacity,
    tree_map,
    tree_slice,
    tree_take,
)
from .builder import REPLAYS, build_sampling

_SKIP_KEYS = ("infos",)


def h5_storable(v):
    """h5py has no bfloat16: store the bit pattern as uint16 plus a
    ``pcrl_dtype`` attr (older h5py silently wrote an opaque ``|V2`` void
    dataset instead, which numpy/jax cannot consume on restore).  A torch
    tensor is stored as its numpy view; a bfloat16 one (numpy has no such
    dtype) as its bits, like a numpy array of an extension bfloat16 dtype
    (kind ``V``)."""
    if is_tensor(v):
        import torch

        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return v.numpy(), None
    arr = np.asarray(v)
    if arr.dtype.itemsize == 2 and arr.dtype.kind not in "fuib":
        return arr.view(np.uint16), "bfloat16"
    return arr, None


def h5_read(ds, sl=None):
    """Read an HDF5 dataset (optionally a row slice), undoing ``h5_storable``:
    ``pcrl_dtype='bfloat16'`` uint16 bit patterns — and legacy opaque 2-byte
    void datasets written before the tag existed — read back as a
    ``torch.bfloat16`` CPU tensor with the same bits."""
    a = np.asarray(ds if sl is None else ds[sl])
    tag = ds.attrs.get("pcrl_dtype") if hasattr(ds, "attrs") else None
    if tag == "bfloat16" or (a.dtype.kind == "V" and a.dtype.itemsize == 2):
        import torch

        a = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return a


def apply_transfer(items: Dict[str, Any], transfer_cfg: Optional[dict]) -> Dict[str, Any]:
    """Storage/wire reductions applied before a replay ingests a batch (see
    algorithms/obs_transfer.py): ``drop_subkeys`` removes keys anywhere in
    the tree (top level included) whose content the update re-synthesizes on
    device (e.g. the constant pos_encoding); ``dtype_map`` narrows matching
    keys' dtypes (e.g. xyz -> float16)."""
    if not transfer_cfg:
        return items
    drop = set(transfer_cfg.get("drop_subkeys", ()))
    dmap = transfer_cfg.get("dtype_map", {})

    def _rec(key, value):
        if isinstance(value, dict):
            return {k: _rec(k, v) for k, v in value.items() if k not in drop}
        if key in dmap and hasattr(value, "astype"):
            return np.asarray(value).astype(dmap[key])
        return value

    return {k: _rec(k, v) for k, v in items.items() if k not in drop}


@REPLAYS.register_module()
class ReplayMemory:
    def __init__(
        self,
        capacity: int,
        sampling_cfg: Optional[dict] = None,
        buffer_filenames: Optional[List[str]] = None,
        keys: Optional[List[str]] = None,
        seed: Optional[int] = None,
        data_coder_cfg: Optional[dict] = None,
        dynamic_loading: Optional[bool] = None,
        cache_files_ahead: int = 2,
        num_samples: int = -1,
        transfer_cfg: Optional[dict] = None,
    ):
        self.capacity = int(capacity)
        self.memory = None
        self.position = 0
        self.running_count = 0
        self.keys = keys
        self.transfer_cfg = dict(transfer_cfg) if transfer_cfg else None
        sampling_cfg = dict(sampling_cfg or {"type": "OneStepTransition"})
        sampling_cfg.setdefault("seed", seed)
        self.sampling = build_sampling(sampling_cfg)
        self._traj_cache: Dict[int, List[dict]] = {}
        # Episode tracking for T-step window sampling (TStepTransition):
        # global (monotonic) index spans per completed episode; a span is
        # valid while none of it has been overwritten by the ring.
        self._episode_spans: List[tuple] = []  # (global_start, length)
        self._open_episodes: Dict[int, tuple] = {}  # worker -> (global_start, length)
        self.data_coder = None
        if data_coder_cfg is not None:
            from ..utils.io import DataCoder

            self.data_coder = DataCoder(**data_coder_cfg)
        # HDF5-dataset backing (reference replay_buffer.py:100-172): when the
        # dataset exceeds capacity, chunks stream in via a background
        # prefetcher and sample() swaps to the next chunk after one pass
        # over the current one (dynamic loading); otherwise everything
        # full-loads once.
        self.dynamic_loading = False
        self._chunk_loader = None
        self._chunk_sampled = 0
        if buffer_filenames:
            self._init_file_backing(list(buffer_filenames), dynamic_loading,
                                    cache_files_ahead, num_samples)

    # ----------------------------------------------------------- properties
    def __len__(self) -> int:
        return min(self.running_count, self.capacity)

    @property
    def size(self) -> int:
        return len(self)

    def reset(self) -> None:
        self.position = 0
        self.running_count = 0
        if self.sampling is not None:
            self.sampling.reset()

    # ----------------------------------------------------------------- push
    def _clean(self, items: Dict[str, Any]) -> Dict[str, Any]:
        items = {k: v for k, v in items.items() if k not in _SKIP_KEYS}
        if self.keys is not None:
            items = {k: v for k, v in items.items() if k in self.keys}
        return apply_transfer(items, self.transfer_cfg)

    def push_batch(self, items: Dict[str, Any]) -> None:
        """Append a [B, ...] transition batch with ring wraparound
        (reference replay_buffer.py:206-231)."""
        items = self._clean(items)
        batch = len(first_leaf(items))
        if batch > self.capacity:
            items = tree_slice(items, slice(0, self.capacity))
            batch = self.capacity
        if self.memory is None:
            self.memory = tree_empty_like_with_capacity(items, self.capacity)
        end = self.position + batch
        if end <= self.capacity:
            tree_assign(self.memory, slice(self.position, end), items)
        else:
            first = self.capacity - self.position
            tree_assign(self.memory, slice(self.position, self.capacity), tree_slice(items, slice(0, first)))
            tree_assign(self.memory, slice(0, end - self.capacity), tree_slice(items, slice(first, batch)))
        self.position = end % self.capacity
        self._track_episodes(items, batch)
        self.running_count += batch

    def _track_episodes(self, items: Dict[str, Any], batch: int) -> None:
        if "episode_dones" not in items:
            return
        dones = np.asarray(items["episode_dones"]).reshape(batch)
        widx = (
            np.asarray(items["worker_indices"]).reshape(batch)
            if "worker_indices" in items
            else np.zeros(batch, np.int64)
        )
        for row in range(batch):
            g = self.running_count + row
            w = int(widx[row])
            start, length = self._open_episodes.get(w, (g, 0))
            if length == 0:
                start = g
            length += 1
            if bool(dones[row]):
                self._episode_spans.append((start, length))
                self._open_episodes.pop(w, None)
            else:
                self._open_episodes[w] = (start, length)
        # Drop spans partially overwritten by the ring.
        min_valid = self.running_count + batch - self.capacity
        if min_valid > 0:
            self._episode_spans = [(s, l) for (s, l) in self._episode_spans if s >= min_valid]

    def sample_windows(self, batch_size: int, horizon: Optional[int] = None) -> Dict[str, Any]:
        """[B, H] temporal windows from completed episodes (TStepTransition
        semantics, reference sampling_strategy.py:105-246).  Adds an
        ``is_valid`` [B, H] mask covering episode-shorter-than-horizon pads."""
        from .sampling_strategy import TStepTransition

        assert isinstance(self.sampling, TStepTransition), "sample_windows needs sampling_cfg type TStepTransition"
        horizon = self.sampling.horizon if horizon is None else horizon
        min_valid = max(self.running_count - self.capacity, 0)
        with span(REPLAY_SAMPLE):
            spans = [(s, s + l) for (s, l) in self._episode_spans if s >= min_valid]
            idx_g, mask = self.sampling.sample_windows(batch_size, spans, horizon=horizon)
            flat = (idx_g % self.capacity).reshape(-1)
            out = tree_take(self.memory, flat)
            H = idx_g.shape[1]
            out = tree_map(lambda x: x.reshape((batch_size, H) + x.shape[1:]), out)
            out["is_valid"] = mask
            return out

    def push(self, item: Dict[str, Any]) -> None:
        self.push_batch(tree_map(lambda x: np.asarray(x)[None], item))

    # ---------------------------------------------- full-episode trajectory
    def cache_trajectories(self, items: Dict[str, Any], max_push: int = -1) -> int:
        """Cache per-worker transitions; push completed episodes
        (reference replay_buffer.py:233-287).  Returns #transitions pushed."""
        items = self._clean(items)
        worker_ids = np.asarray(items["worker_indices"]).reshape(-1)
        pushed = 0
        for row, wid in enumerate(worker_ids):
            wid = int(wid)
            tr = tree_slice(items, slice(row, row + 1))
            self._traj_cache.setdefault(wid, []).append(tr)
            if bool(np.asarray(tr["episode_dones"]).reshape(-1)[0]):
                episode = tree_concat(self._traj_cache.pop(wid), 0)
                n = len(first_leaf(episode))
                if max_push >= 0 and pushed + n > max_push:
                    n_take = max_push - pushed
                    if n_take <= 0:
                        continue
                    episode = tree_slice(episode, slice(0, n_take))
                    n = n_take
                self.push_batch(episode)
                pushed += n
        return pushed

    def push_cached_trajectories(self, max_push: int = -1) -> int:
        """Flush incomplete cached trajectories (straggler cutoff path)."""
        pushed = 0
        for wid in list(self._traj_cache):
            parts = self._traj_cache.pop(wid)
            if not parts:
                continue
            episode = tree_concat(parts, 0)
            n = len(first_leaf(episode))
            if max_push >= 0:
                n = min(n, max_push - pushed)
                if n <= 0:
                    continue
                episode = tree_slice(episode, slice(0, n))
            self.push_batch(episode)
            pushed += n
        return pushed

    # ------------------------------------------------- hdf5 dataset backing
    @staticmethod
    def _hdf5_units(filenames: List[str], capacity: int, num_samples: int):
        """Split the dataset into load units of <= capacity transitions.

        A unit is a list of (filename, traj_key_or_None, start, stop) slices;
        traj_key None means the file stores a flat tree (leaves [N, ...]).
        """
        import h5py

        units, cur, cur_len, total = [], [], 0, 0
        entries = []  # (filename, traj_key_or_None, length)
        for fn in filenames:
            with h5py.File(fn, "r") as f:
                traj_keys = sorted(k for k in f.keys() if k.startswith("traj"))
                if num_samples > 0:
                    traj_keys = traj_keys[:num_samples]
                if traj_keys:
                    for tk in traj_keys:
                        grp = f[tk]
                        first = next(iter(grp.values()))
                        while hasattr(first, "values"):
                            first = next(iter(first.values()))
                        entries.append((fn, tk, len(first)))
                else:
                    first = next(iter(f.values()))
                    while hasattr(first, "values"):
                        first = next(iter(first.values()))
                    entries.append((fn, None, len(first)))
        for fn, tk, n in entries:
            total += n
            start = 0
            while start < n:
                take = min(n - start, capacity - cur_len)
                cur.append((fn, tk, start, start + take))
                cur_len += take
                start += take
                if cur_len == capacity:
                    units.append(cur)
                    cur, cur_len = [], 0
        if cur:
            units.append(cur)
        return units, total

    def _load_unit(self, unit) -> Dict[str, Any]:
        import h5py

        from ..utils.tree_ops import tree_concat

        parts = []
        for fn, tk, start, stop in unit:
            with h5py.File(fn, "r") as f:
                grp = f[tk] if tk is not None else f

                def _load(g):
                    return {k: (_load(v) if hasattr(v, "items") else np.asarray(v[start:stop]))
                            for k, v in g.items()}

                parts.append(_load(grp))
        data = tree_concat(parts, 0) if len(parts) > 1 else parts[0]
        if self.data_coder is not None:
            data = self.data_coder.decode(data)
        return data

    def _init_file_backing(self, filenames, dynamic_loading, ahead, num_samples):
        units, total = self._hdf5_units(filenames, self.capacity, num_samples)
        if dynamic_loading is None:
            dynamic_loading = total > self.capacity
        self.dynamic_loading = bool(dynamic_loading)
        if not self.dynamic_loading:
            for unit in units:
                self.push_batch(self._load_unit(unit))
            return
        # chunks stream through a background prefetcher; one pass over each
        # chunk, then swap (reference replay_buffer.py:134-138, 297-314)
        from ..utils.io import FileCache

        self._chunk_loader = FileCache(units, loader=self._load_unit, ahead=ahead, loop=True)
        self._swap_chunk()

    def _swap_chunk(self) -> None:
        _, data = self._chunk_loader.get()
        assert data is not None, "dataset prefetcher closed unexpectedly"
        self.reset()
        self.push_batch(data)
        self._chunk_sampled = 0

    # --------------------------------------------------------------- sample
    def sample(self, batch_size: int) -> Dict[str, Any]:
        if self.dynamic_loading and self._chunk_sampled + batch_size > len(self):
            self._swap_chunk()
        self._chunk_sampled += batch_size
        with span(REPLAY_SAMPLE):
            idx = self.sampling.sample(batch_size, len(self), self.capacity)
            return tree_take(self.memory, idx)

    def tail(self, num: int) -> Dict[str, Any]:
        """The most recent num transitions in push order."""
        num = min(num, len(self))
        idx = (np.arange(self.position - num, self.position)) % self.capacity
        return tree_take(self.memory, idx)

    def get_all(self) -> Dict[str, Any]:
        return tree_slice(self.memory, slice(0, len(self)))

    def mini_batch_sampler(self, batch_size: int, drop_last: bool = False, shuffle: bool = True):
        """Epoch iterator over the whole buffer (reference replay_buffer.py:324)."""
        n = len(self)
        order = np.random.permutation(n) if shuffle else np.arange(n)
        for s in range(0, n, batch_size):
            chunk = order[s : s + batch_size]
            if drop_last and len(chunk) < batch_size:
                return
            yield tree_take(self.memory, chunk)

    # ----------------------------------------------------------------- hdf5
    def to_hdf5(self, filename: str, compression: str = "gzip") -> None:
        """Dump the buffer as one HDF5 tree.  ``compression="lzf"`` trades
        ~1.5x file size for a 5-10x faster write — the right choice for the
        periodic in-training snapshot, where the write stalls the train loop
        on the single host core (gzip measured ~10 min for a 50k-step
        pointcloud replay vs ~1 min lzf).  Loads are codec-transparent."""
        import h5py

        data = self.get_all()
        with h5py.File(filename, "w") as f:

            def _dump(group, tree):
                for k, v in tree.items():
                    if isinstance(v, dict):
                        _dump(group.create_group(k), v)
                    else:
                        arr, tag = h5_storable(v)
                        ds = group.create_dataset(k, data=arr, compression=compression)
                        if tag:
                            ds.attrs["pcrl_dtype"] = tag

            _dump(f, data)

    def load_hdf5(self, filename: str) -> None:
        import h5py

        with h5py.File(filename, "r") as f:

            def _load(group):
                out = {}
                for k, v in group.items():
                    out[k] = _load(v) if hasattr(v, "items") else h5_read(v)
                return out

            data = _load(f)
        self.push_batch(data)

    def close(self) -> None:
        if self._chunk_loader is not None:
            self._chunk_loader.close()
            self._chunk_loader = None
