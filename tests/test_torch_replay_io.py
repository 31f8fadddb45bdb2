"""The port's file I/O and replay persistence against the JAX package's.

``pointcloud_rl_torch/utils/io.py`` is a copy of the JAX package's module,
and the replays read and write the same files: ``load`` / ``dump`` by
extension, the codecs (``float_to_int`` / ``int_to_float``, ``DataCoder``
over f16, quantisation and the three PNG codecs), ``FileCache``, HDF5
datasets flat or in ``traj_*`` groups streamed in chunks (dynamic
loading), and replay snapshots with bfloat16 leaves, which h5py stores as
uint16 bits with a ``pcrl_dtype`` tag.  Each test feeds both packages the
same inputs, made from a seed with numpy, and asks for equal results, bit
for bit: the formats and the sampling are the same code on both sides.
``save_replay`` is driven through each package's ``train_rl`` with a stub
agent (the loop's snapshot does not depend on the agent).
"""

import os
import os.path as osp

import h5py
import numpy as np
import pytest
import torch

from pointcloud_rl_torch.utils import io as t_io
from pointcloud_rl_tpu.utils import io as j_io

torch.set_num_threads(1)


# ------------------------------------------------------------------ load / dump
def _objects(ext):
    rs = np.random.RandomState(0)
    return {
        ".pkl": {"a": 1, "b": [1, 2, 3], "arr": rs.randn(3, 2)},
        ".json": {"a": 1, "b": [1, 2.5, "x"], "c": {"d": None}},
        ".yaml": {"a": 1, "b": [1, 2, 3], "c": {"d": "e"}},
        ".csv": [{"x": "1", "y": "2"}, {"x": "3", "y": "4"}],
        ".txt": "hello\nworld",
        ".npy": rs.randn(4, 3).astype(np.float32),
        ".h5": {"obs": {"xyz": rs.randn(5, 3).astype(np.float32)}, "r": np.arange(5, dtype=np.int64)},
    }[ext]


def _assert_same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("writer", ["torch", "jax"])
@pytest.mark.parametrize("ext", [".pkl", ".json", ".yaml", ".csv", ".txt", ".npy", ".h5"])
def test_dump_load_round_trips_across_packages(ext, writer, tmp_path):
    obj = _objects(ext)
    path = str(tmp_path / f"sub/x{ext}")
    (t_io if writer == "torch" else j_io).dump(obj, path)
    got, want = t_io.load(path), j_io.load(path)
    _assert_same(got, want)
    if ext in (".npy", ".h5", ".txt", ".csv", ".yaml", ".json"):
        _assert_same(got, obj)


def test_unknown_extension_raises_in_both():
    for mod in (t_io, j_io):
        with pytest.raises(KeyError):
            mod.load("x.unknown")


# --------------------------------------------------------------------- codecs
QUANTIZE_CASES = {
    "range_uint8": ((0.0, 1.0), None, "uint8"),
    "range_uint16": ((-2.0, 5.0), None, "uint16"),
    "res_int16": (None, 1e-3, "int16"),
    "range_int8": ((-1.0, 1.0), None, "int8"),
}


@pytest.mark.parametrize("case", sorted(QUANTIZE_CASES))
def test_quantize_codecs_are_bitwise_the_originals(case):
    vrange, res, dtype = QUANTIZE_CASES[case]
    rs = np.random.RandomState(1)
    x = rs.uniform(-3, 6, (64, 3)).astype(np.float32)
    q = t_io.float_to_int(x, vrange=vrange, res=res, dtype=dtype)
    np.testing.assert_array_equal(q, j_io.float_to_int(x, vrange=vrange, res=res, dtype=dtype))
    assert q.dtype == np.dtype(dtype)
    back = t_io.int_to_float(q, vrange=vrange, res=res)
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back, j_io.int_to_float(q, vrange=vrange, res=res))
    # integers and floats pass through as the original passes them
    np.testing.assert_array_equal(t_io.float_to_int(q, dtype="int32"), j_io.float_to_int(q, dtype="int32"))
    np.testing.assert_array_equal(t_io.int_to_float(x), j_io.int_to_float(x))


def _coded(mod, codec, rs):
    coder = mod.DataCoder
    if codec == "f16":
        tree = {"xyz": rs.randn(6, 3).astype(np.float32), "rgb": rs.randint(0, 255, (6, 3)).astype(np.uint8),
                "nested": {"depth": rs.rand(6, 2).astype(np.float32)}}
        c = coder()
        enc = c.encode(tree)
        return enc, c.decode(enc)
    if codec == "quantize":
        tree = {"xyz": rs.uniform(-1, 1, (10, 3)).astype(np.float32), "actions": rs.randn(10, 2).astype(np.float32)}
        c = coder(f16=False, compress_cfg={"xyz": ("quantize", None, 1e-3, "int16")})
        enc = c.encode(tree)
        return enc, c.decode(enc)
    if codec == "rgb_png":
        img = rs.randint(0, 255, (24, 32, 3), dtype=np.uint8)
        data = coder.encode_png(img)
        return data, coder.decode_png(data)
    if codec == "depth_png":
        depth = rs.randint(0, 65535, (24, 32), dtype=np.uint16)
        data = coder.encode_depth_png(depth)
        return data, coder.decode_depth_png(data)
    seg = rs.rand(24, 32, 5) > 0.5
    data = coder.encode_seg_png(seg)
    return data, coder.decode_seg_png(data)


@pytest.mark.parametrize("codec", ["f16", "quantize", "rgb_png", "depth_png", "seg_png"])
def test_data_coder_is_bitwise_the_original(codec):
    (t_enc, t_dec), (j_enc, j_dec) = (_coded(mod, codec, np.random.RandomState(2)) for mod in (t_io, j_io))
    if isinstance(t_enc, bytes):
        assert t_enc == j_enc
        np.testing.assert_array_equal(t_dec, j_dec)
        assert t_dec.dtype == j_dec.dtype
    else:
        for got, want in ((t_enc, j_enc), (t_dec, j_dec)):
            _assert_same(got, want)


# ----------------------------------------------------------------- FileCache
def _json_files(tmp_path, n=3):
    paths = []
    for i in range(n):
        p = str(tmp_path / f"f{i}.json")
        j_io.dump({"i": i}, p)
        paths.append(p)
    return paths


def _drain(mod, paths, loop, n, loader=None):
    cache = mod.FileCache(paths, loader=loader or mod.load, ahead=2, loop=loop)
    try:
        return [cache.get(timeout=10) for _ in range(n)]
    finally:
        cache.close()


@pytest.mark.parametrize("loop", [False, True], ids=["once", "loop"])
def test_file_cache_keeps_the_originals_order(loop, tmp_path):
    paths = _json_files(tmp_path)
    n = 7 if loop else 4  # once: three files, then the end marker
    got, want = _drain(t_io, paths, loop, n), _drain(j_io, paths, loop, n)
    assert got == want
    assert [p for p, _ in got[:3]] == paths
    if not loop:
        assert got[3] == (None, None)
    else:
        assert [d["i"] for _, d in got] == [0, 1, 2, 0, 1, 2, 0]


def test_file_cache_raises_loader_errors_in_get(tmp_path):
    paths = _json_files(tmp_path)

    def loader(path):
        if path.endswith("f1.json"):
            raise ValueError(f"bad file {osp.basename(path)}")
        return j_io.load(path)

    for mod in (t_io, j_io):
        cache = mod.FileCache(paths, loader=loader, ahead=1, loop=False)
        try:
            assert cache.get(timeout=10)[1] == {"i": 0}
            with pytest.raises(ValueError, match="bad file f1.json"):
                cache.get(timeout=10)
            assert cache.get(timeout=10)[1] == {"i": 2}
        finally:
            cache.close()


def test_file_cache_close_stops_its_thread(tmp_path):
    """A looping cache with a full queue: close ends the thread and joins
    it, so no loader runs on while the interpreter exits."""
    cache = t_io.FileCache(_json_files(tmp_path), ahead=1, loop=True)
    assert cache.get(timeout=10)[1] == {"i": 0}
    cache.close()
    assert not cache._thread.is_alive()


# ------------------------------------------------------------ dynamic loading
def _trajectory_file(path, n_trajs, traj_len, seed, dtype=np.float32):
    rs = np.random.RandomState(seed)
    with h5py.File(path, "w") as f:
        for t in range(n_trajs):
            g = f.create_group(f"traj_{t}")
            g.create_dataset("obs", data=rs.randn(traj_len, 4).astype(dtype))
            g.create_dataset("next_obs", data=rs.randn(traj_len, 4).astype(dtype))
            g.create_dataset("actions", data=np.clip(rs.randn(traj_len, 2), -1, 1).astype(np.float32))
            g.create_dataset("rewards", data=(1000 * seed + 100 * t + np.arange(traj_len))[:, None].astype(np.float32))
            g.create_dataset("dones", data=np.zeros((traj_len, 1), bool))
            g.create_dataset("episode_dones", data=np.zeros((traj_len, 1), bool))
    return str(path)


def _flat_file(path, n, seed):
    rs = np.random.RandomState(seed)
    with h5py.File(path, "w") as f:
        f.create_dataset("obs/xyz", data=rs.randn(n, 5, 3).astype(np.float32))
        f.create_dataset("obs/state", data=rs.randn(n, 4).astype(np.float32))
        f.create_dataset("actions", data=rs.randn(n, 2).astype(np.float32))
        f.create_dataset("rewards", data=(1000 * seed + np.arange(n))[:, None].astype(np.float32))
    return str(path)


# name: (files(tmp_path), ReplayMemory kwargs)
DATASETS = {
    "traj": (lambda d: [_trajectory_file(d / "a.h5", 6, 20, 0)], dict(capacity=40)),
    "traj_num_samples": (lambda d: [_trajectory_file(d / "a.h5", 6, 20, 0), _trajectory_file(d / "b.h5", 5, 13, 1)],
                         dict(capacity=32, num_samples=4)),
    "flat_files": (lambda d: [_flat_file(d / "a.h5", 50, 0), _flat_file(d / "b.h5", 37, 1)], dict(capacity=30)),
    "traj_f16_data_coder": (lambda d: [_trajectory_file(d / "a.h5", 4, 25, 2, np.float16)],
                            dict(capacity=30, data_coder_cfg=dict(f16=True))),
    "fits_in_capacity": (lambda d: [_trajectory_file(d / "a.h5", 3, 10, 3)], dict(capacity=100)),
}


def _sample_sequence(cls, files, kwargs, batch, n_batches):
    """(dynamic flag, samples, the sample numbers at which a chunk swap
    happened) over ``n_batches`` batches."""
    mem = cls(buffer_filenames=files, seed=7, **kwargs)
    swaps = []
    inner = mem._swap_chunk

    def counting():
        swaps.append(len(samples))
        inner()

    mem._swap_chunk = counting
    samples = []
    try:
        for _ in range(n_batches):
            samples.append(mem.sample(batch))
    finally:
        mem.close()
    return mem.dynamic_loading, samples, swaps


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_dynamic_loading_swaps_and_samples_like_the_original(name, tmp_path):
    """For the same files, capacity and seed, the port streams the same
    chunks and draws the same batches as the JAX package's replay, over 3
    passes of the dataset."""
    from pointcloud_rl_torch.env.replay import ReplayMemory as T
    from pointcloud_rl_tpu.env.replay import ReplayMemory as J

    make_files, kwargs = DATASETS[name]
    files = make_files(tmp_path)
    total = T._hdf5_units(files, kwargs["capacity"], kwargs.get("num_samples", -1))[1]
    batch = 10
    n_batches = 3 * total // batch
    t_dyn, t_samples, t_swaps = _sample_sequence(T, files, kwargs, batch, n_batches)
    j_dyn, j_samples, j_swaps = _sample_sequence(J, files, kwargs, batch, n_batches)
    assert t_dyn == j_dyn == (name != "fits_in_capacity")
    assert t_swaps == j_swaps
    if t_dyn:
        assert len(t_swaps) >= 3
    for got, want in zip(t_samples, j_samples):
        _assert_same(got, want)
    seen = {float(r) for s in t_samples for r in s["rewards"].reshape(-1)}
    assert len(seen) > kwargs["capacity"] or not t_dyn  # the batches span several chunks


# --------------------------------------------------------------- bf16 leaves
def test_a_torch_bf16_leaf_round_trips_bitwise(tmp_path):
    """A bfloat16 tensor (which numpy cannot hold) is written as its uint16
    bits with the tag and read back as a bfloat16 tensor with the same bits,
    alone and through a host replay's ``to_hdf5`` / ``load_hdf5``."""
    from pointcloud_rl_torch.env.replay import ReplayMemory, h5_read, h5_storable

    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(12, 5, 3, generator=gen) * 100).to(torch.bfloat16)
    x[0, 0, 0] = float("inf")
    x[0, 0, 1] = float("nan")
    arr, tag = h5_storable(x)
    assert arr.dtype == np.uint16 and tag == "bfloat16"
    path = str(tmp_path / "x.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=arr).attrs["pcrl_dtype"] = tag
    with h5py.File(path, "r") as f:
        back = h5_read(f["x"])
        part = h5_read(f["x"], slice(3, 7))
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), x.view(torch.int16))
    assert torch.equal(part.view(torch.int16), x[3:7].view(torch.int16))

    mem = ReplayMemory(16)
    mem.push_batch({"obs": {"pcd": x}, "rewards": np.arange(12, dtype=np.float32)[:, None]})
    mem.to_hdf5(path, compression="lzf")
    host = ReplayMemory(16)
    host.load_hdf5(path)
    got = host.get_all()
    assert torch.equal(got["obs"]["pcd"].view(torch.int16), x.view(torch.int16))
    np.testing.assert_array_equal(got["rewards"][:, 0], np.arange(12))
    s = host.sample(5)
    assert s["obs"]["pcd"].dtype == torch.bfloat16 and s["obs"]["pcd"].shape == (5, 5, 3)


def test_legacy_untagged_void_datasets_read_as_bf16(tmp_path):
    import ml_dtypes

    from pointcloud_rl_torch.env.replay import h5_read as t_read
    from pointcloud_rl_tpu.env.replay import h5_read as j_read

    bits = np.random.RandomState(3).randint(0, 2**15, (6, 4)).astype(np.uint16)
    path = str(tmp_path / "legacy.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("obs/pcd", data=bits.view(np.void(2).dtype))
    with h5py.File(path, "r") as f:
        got, want = t_read(f["obs/pcd"]), j_read(f["obs/pcd"])
    assert got.dtype == torch.bfloat16 and want.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want.view(np.uint16))
    np.testing.assert_array_equal(want.view(np.uint16), bits)


def _raw(n, start, n_points=24, seed=0):
    """``n`` raw point-cloud transitions whose rewards carry their global
    index ``start + i`` (a pos_encoding block of 3 frames, as the DMC
    stacks ship it)."""
    rs = np.random.RandomState(seed + start)
    pe = np.tile(np.eye(3, dtype=np.float32)[:, :, None], (1, 1, n_points // 3)).reshape(3, n_points)

    def obs():
        return {"xyz": rs.randn(n, 3, n_points).astype(np.float32),
                "rgb": rs.randint(0, 256, (n, 3, n_points)).astype(np.uint8),
                "pos_encoding": np.repeat(pe[None], n, 0)}

    return {"obs": obs(), "next_obs": obs(), "actions": rs.uniform(-1, 1, (n, 2)).astype(np.float32),
            "rewards": (start + np.arange(n, dtype=np.float32))[:, None],
            "dones": rs.rand(n, 1) < 0.1, "episode_dones": np.zeros((n, 1), bool)}


def _fill(mem, pushes):
    at = 0
    for n in pushes:
        mem.push_batch(_raw(n, at))
        at += n
    return at


PUSHES = (10, 7, 13, 9, 11)  # 50 transitions into a ring of 32: wrapped, position 18


def _t_ring(capacity=32, seed=0):
    from pointcloud_rl_torch.env.device_replay import DeviceReplayMemory

    return DeviceReplayMemory(capacity, seed=seed, transfer_cfg=dict(pack_features=True), device="cpu")


def _j_ring(capacity=32, seed=0):
    from pointcloud_rl_tpu.env.device_replay import DeviceReplayMemory

    return DeviceReplayMemory(capacity, seed=seed, transfer_cfg=dict(pack_features=True))


def _bits(x):
    """A leaf as numpy, bfloat16 (torch or ml_dtypes) as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.itemsize == 2 and x.dtype.kind not in "fuib" else x


def _assert_bitwise(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_bitwise(got[k], want[k])
        return
    a, b = _bits(got), _bits(want)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def _read_file(path):
    """Every dataset of an HDF5 file as stored (uint16 bits stay uint16), and its tags."""
    with h5py.File(path, "r") as f:
        def walk(g):
            return {k: walk(v) if hasattr(v, "items") else (np.asarray(v), v.attrs.get("pcrl_dtype"))
                    for k, v in g.items()}
        return walk(f)


def test_the_packed_ring_matches_the_original_ring():
    """The port's packed bf16 ring and the JAX package's hold the same bits
    after the same wrapped pushes (the premise of the snapshot tests)."""
    t, j = _t_ring(), _j_ring()
    assert _fill(t, PUSHES) == _fill(j, PUSHES) == 50
    assert (t.position, len(t)) == (j.position, len(j)) == (18, 32)
    _assert_bitwise(t.tail(32), j.tail(32))
    _assert_bitwise(t.get_all(), j.get_all())
    assert t.storage["obs"]["pcd"].dtype == torch.bfloat16


@pytest.mark.parametrize("num", [5, 4096, 4097, 8195])
def test_chunked_gather_is_bitwise_the_whole_gather(num):
    """A wrapped ring of more than two gather chunks (``CHUNK`` rows): the
    chunked ``get_all`` and ``tail`` are bitwise the one-piece gather, for
    tails within one chunk, of exactly one, and across two and three."""
    from pointcloud_rl_torch.env.device_replay import CHUNK

    cap = 2 * CHUNK + 5
    t = _t_ring(capacity=cap)
    total = _fill(t, (4000, 3000, 3000))
    assert len(t) == cap and t.position == total - cap
    _assert_bitwise(t.get_all(), t.gather(torch.arange(cap)))
    tail = t.tail(num)
    np.testing.assert_array_equal(tail["rewards"][:, 0].numpy(), np.arange(total - num, total))
    _assert_bitwise(tail, t.gather(torch.as_tensor(np.arange(total - num, total) % cap)))


class _StubAgent:
    """What ``train_rl`` needs of an agent in offline mode, with updates
    that do nothing: its snapshot does not depend on the agent."""

    def __init__(self, torch_side):
        if torch_side:
            from pointcloud_rl_torch.parallel import DataParallel

            self.data_parallel = DataParallel()
        self.device = torch.device("cpu")
        self.updates = 0

    def train(self):
        pass

    def eval(self):
        pass

    def state_dict(self):
        return {"w": np.zeros(2, np.float32)}

    def update_parameters(self, memory, updates):
        self.updates += 1
        return {}


def _train_offline(side, replay, work_dir, save_replay, total=4, n_checkpoint=2, **kwargs):
    if side == "torch":
        from pointcloud_rl_torch.apis.train_rl import train_rl
    else:
        from pointcloud_rl_tpu.apis.train_rl import train_rl
    agent = _StubAgent(side == "torch")
    train_rl(agent, None, None, replay, work_dir=str(work_dir), total_steps=total, warm_steps=0, n_steps=0,
             n_updates=1, n_log=2, n_eval=-1, n_checkpoint=n_checkpoint, save_replay=save_replay, **kwargs)
    return agent


@pytest.mark.parametrize("save_replay", [16, 0, -1])
def test_save_replay_writes_the_newest_transitions_or_nothing(save_replay, tmp_path):
    t = _t_ring()
    _fill(t, PUSHES)
    _train_offline("torch", t, tmp_path, save_replay)
    models = sorted(os.listdir(tmp_path / "models"))
    if save_replay <= 0:
        assert models == ["model_2", "model_4", "model_final"]
        return
    assert models == ["model_2", "model_4", "model_final", "replay_latest.h5"]  # no .tmp left
    snap = _read_file(tmp_path / "models" / "replay_latest.h5")
    np.testing.assert_array_equal(snap["rewards"][0][:, 0], np.arange(34, 50))  # push order, not storage order
    assert snap["obs"]["pcd"][1] == "bfloat16" and snap["obs"]["pcd"][0].dtype == np.uint16


@pytest.mark.parametrize("save_replay", [20, 64])
def test_save_replay_file_equals_the_jax_loops(save_replay, tmp_path):
    """Same replay contents: the port's ``replay_latest.h5`` holds the same
    datasets, dtypes, tags and bits as the JAX loop's; and each package's
    file restores into the other's packed ring bitwise."""
    t, j = _t_ring(), _j_ring()
    _fill(t, PUSHES)
    _fill(j, PUSHES)
    _train_offline("torch", t, tmp_path / "t", save_replay)
    _train_offline("jax", j, tmp_path / "j", save_replay)
    t_path, j_path = (str(tmp_path / s / "models" / "replay_latest.h5") for s in ("t", "j"))
    t_file, j_file = _read_file(t_path), _read_file(j_path)

    def same(a, b):
        if isinstance(b, dict):
            assert sorted(a) == sorted(b)
            for k in b:
                same(a[k], b[k])
        else:
            assert a[1] == b[1] and a[0].dtype == b[0].dtype
            np.testing.assert_array_equal(a[0], b[0])

    same(t_file, j_file)
    n = min(save_replay, 32)
    assert len(t_file["rewards"][0]) == n
    newest = t.tail(n)
    # the port's file into the JAX ring, the JAX file into the port's ring
    j_fresh, t_fresh = _j_ring(seed=3), _t_ring(seed=3)
    j_fresh.load_hdf5(t_path, chunk=7)
    t_fresh.load_hdf5(j_path, chunk=7)
    assert len(j_fresh) == len(t_fresh) == n
    _assert_bitwise(j_fresh.tail(n), newest)
    _assert_bitwise(t_fresh.tail(n), newest)
    # and each restores into a host replay of its own package alike
    from pointcloud_rl_torch.env.replay import ReplayMemory as T
    from pointcloud_rl_tpu.env.replay import ReplayMemory as J

    th, jh = T(64), J(64)
    th.load_hdf5(j_path)
    jh.load_hdf5(t_path)
    _assert_bitwise(th.get_all(), jh.get_all())


def test_to_hdf5_writes_storage_order_like_the_original(tmp_path):
    t, j = _t_ring(), _j_ring()
    _fill(t, PUSHES)
    _fill(j, PUSHES)
    t.to_hdf5(str(tmp_path / "t.h5"))
    j.to_hdf5(str(tmp_path / "j.h5"))
    t_file, j_file = _read_file(tmp_path / "t.h5"), _read_file(tmp_path / "j.h5")
    np.testing.assert_array_equal(t_file["rewards"][0][:, 0], np.r_[32:50, 18:32])
    for key in ("rewards", "actions", "dones"):
        np.testing.assert_array_equal(t_file[key][0], j_file[key][0])
    for key in ("obs", "next_obs"):
        assert t_file[key]["pcd"][1] == j_file[key]["pcd"][1] == "bfloat16"
        np.testing.assert_array_equal(t_file[key]["pcd"][0], j_file[key]["pcd"][0])


def test_a_packed_restore_is_not_packed_again(monkeypatch, tmp_path):
    """A packed ring's snapshot holds the model-input tensors: the restore
    stores them as they are (no pack call), bitwise, through the chunk
    loop; later raw pushes pack as in the original ring."""
    from pointcloud_rl_torch.algorithms import obs_transfer
    from pointcloud_rl_torch.apis.train_rl import save_replay_snapshot

    t = _t_ring()
    total = _fill(t, PUSHES)
    os.makedirs(tmp_path / "models")
    assert save_replay_snapshot(t, 24, str(tmp_path)) == 24
    calls = []
    real = obs_transfer.pack_device_features
    monkeypatch.setattr(obs_transfer, "pack_device_features", lambda *a, **k: calls.append(1) or real(*a, **k))
    fresh = _t_ring(seed=5)
    fresh.load_hdf5(str(tmp_path / "models" / "replay_latest.h5"), chunk=5)
    assert calls == [] and len(fresh) == 24 and fresh.position == 24
    assert set(fresh.storage["obs"]) == {"pcd"} and fresh.storage["obs"]["pcd"].dtype == torch.bfloat16
    _assert_bitwise(fresh.tail(24), t.tail(24))
    more = _raw(6, total)
    fresh.push_batch(more)
    assert len(calls) == 2  # obs and next_obs of the raw push
    t.push_batch(more)
    _assert_bitwise(fresh.tail(30), t.tail(30))


def test_the_snapshot_restores_into_a_host_replay_like_the_original(tmp_path):
    """A host replay's own snapshot (``save_replay`` over a host
    ``ReplayMemory``): same file as the JAX loop's, same restore."""
    from pointcloud_rl_torch.env.replay import ReplayMemory as T
    from pointcloud_rl_tpu.env.replay import ReplayMemory as J

    t, j = T(32), J(32)
    _fill(t, PUSHES)
    _fill(j, PUSHES)
    _train_offline("torch", t, tmp_path / "t", 25)
    _train_offline("jax", j, tmp_path / "j", 25)
    files = [str(tmp_path / s / "models" / "replay_latest.h5") for s in ("t", "j")]
    a, b = T(32), J(32)
    a.load_hdf5(files[1])
    b.load_hdf5(files[0])
    _assert_bitwise(a.get_all(), b.get_all())
    np.testing.assert_array_equal(a.get_all()["rewards"][:, 0], np.arange(25, 50))
