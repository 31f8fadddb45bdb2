"""The port's ``DeviceReplayMemory`` against the JAX package's.

The same pushes (one of them across the ring's end, one through the
full-episode cache) leave the same storage in both, in every storage mode:
raw obs dicts, ``pack_features`` (bf16 model-input tensors, bitwise equal
to the JAX ``pack_device_features``), packing with the pos_encoding block
stripped and re-synthesized, and a ``drop_subkeys`` transfer.  A sample at
the indices the JAX buffer draws gathers the same rows; ``len``,
``position`` and ``tail`` agree.  The port's buffer runs here on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_rl_torch.algorithms.obs_transfer import pack_device_features, synth_pos_encoding
from pointcloud_rl_torch.apis.run_rl import replay_summary
from pointcloud_rl_torch.env import build_replay
from pointcloud_rl_torch.env.device_replay import DeviceReplayMemory
from pointcloud_rl_tpu.algorithms import obs_transfer as j_obs_transfer
from pointcloud_rl_tpu.env.device_replay import DeviceReplayMemory as JaxDeviceReplayMemory

torch.set_num_threads(1)

CAPACITY = 10
N_POINTS = 16


def _obs(rs, n, frames):
    obs = {
        "xyz": rs.randn(n, 3, N_POINTS).astype(np.float32),
        "rgb": rs.randint(0, 256, (n, 3, N_POINTS)).astype(np.uint8),
        "seg": (rs.rand(n, 2, N_POINTS) < 0.3).astype(np.float32),
        "state": rs.randn(n, 5).astype(np.float32),
    }
    if frames:
        pe = np.repeat(np.eye(frames, dtype=np.float32), N_POINTS // frames, axis=-1)
        obs["pos_encoding"] = np.broadcast_to(pe, (n,) + pe.shape).copy()
    return obs


def _transitions(seed, n, frames=0):
    rs = np.random.RandomState(seed)
    return {
        "obs": _obs(rs, n, frames),
        "next_obs": _obs(rs, n, frames),
        "actions": rs.randn(n, 3).astype(np.float32),
        "rewards": rs.randn(n, 1).astype(np.float32),
        "dones": rs.rand(n, 1) < 0.2,
        "episode_dones": rs.rand(n, 1) < 0.3,
        "worker_indices": (np.arange(n) % 2)[:, None],
        "infos": {"success": rs.rand(n, 1) < 0.5},
    }


def _np(tree):
    """A storage tree as numpy (bf16 as its exact f32 values)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy() if tree.dtype == torch.bfloat16 else tree.numpy()
    tree = np.asarray(tree.astype(jnp.float32) if tree.dtype == jnp.bfloat16 else tree)
    return tree


def _assert_same_tree(got, want, what, rtol=0.0):
    got, want = _np(got), _np(want)
    assert sorted(got) == sorted(want), what
    for key in want:
        if isinstance(want[key], dict):
            _assert_same_tree(got[key], want[key], f"{what}/{key}", rtol)
        elif rtol:
            np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=0, err_msg=f"{what}/{key}")
        else:
            np.testing.assert_array_equal(got[key], want[key].astype(got[key].dtype), err_msg=f"{what}/{key}")


# f32 packing: XLA computes rgb / 255 as rgb * (1 / 255), which differs from
# the division by up to one f32 ulp (2^-23 relative); in bf16 both round to
# the same value for all 256 colours (test_pack_device_features_...).
F32_PACK_RTOL = 2.0 ** -23


MODES = {
    "raw": (None, 0),
    "pack_bf16": (dict(pack_features=True), 0),
    "pack_bf16_pos_encoding": (dict(pack_features=True), 2),
    "pack_f32": (dict(pack_features="float32"), 0),
    "drop_pos_encoding": (dict(drop_subkeys=("pos_encoding",)), 2),
}


def _pair(mode, seed=3):
    transfer_cfg, _ = MODES[mode]
    j_mem = JaxDeviceReplayMemory(CAPACITY, seed=seed, transfer_cfg=transfer_cfg)
    t_mem = DeviceReplayMemory(CAPACITY, seed=seed, transfer_cfg=transfer_cfg, device="cpu")
    return j_mem, t_mem


@pytest.mark.parametrize("mode", sorted(MODES))
def test_pushes_leave_the_same_storage(mode):
    _, frames = MODES[mode]
    rtol = F32_PACK_RTOL if mode == "pack_f32" else 0.0
    j_mem, t_mem = _pair(mode)
    for step, n in enumerate((4, 4, 4, 3)):  # the third push wraps around
        batch = _transitions(step, n, frames)
        j_mem.push_batch(batch)
        t_mem.push_batch(batch)
        assert (len(t_mem), t_mem.position, t_mem.running_count) == (len(j_mem), j_mem.position, j_mem.running_count)
        _assert_same_tree(t_mem.storage, j_mem.storage, f"{mode} after push {step}", rtol)
    # full-episode pushes go through the host replay's trajectory cache
    batch = _transitions(9, 6, frames)
    assert t_mem.cache_trajectories(batch) == j_mem.cache_trajectories(batch)
    assert t_mem.push_cached_trajectories() == j_mem.push_cached_trajectories()
    _assert_same_tree(t_mem.storage, j_mem.storage, f"{mode} after the trajectory cache", rtol)
    assert (len(t_mem), t_mem.position) == (len(j_mem), j_mem.position)
    _assert_same_tree(t_mem.tail(7), j_mem.tail(7), f"{mode} tail", rtol)
    if mode.startswith("pack"):
        assert set(t_mem.storage["obs"]) == {"pcd", "state"}
        dtype = torch.float32 if mode == "pack_f32" else torch.bfloat16
        assert t_mem.storage["obs"]["pcd"].dtype == dtype
        assert tuple(t_mem.storage["obs"]["pcd"].shape) == (CAPACITY, N_POINTS, 8 + frames)
    if mode == "drop_pos_encoding":
        assert "pos_encoding" not in t_mem.storage["obs"]
    summary = replay_summary(t_mem)
    leaves = jax.tree_util.tree_leaves(t_mem.storage)
    assert summary["storage_bytes"] == sum(t.numel() * t.element_size() for t in leaves)
    assert summary["type"] == "DeviceReplayMemory" and summary["device"] == "cpu" and summary["size"] == len(j_mem)


@pytest.mark.parametrize("mode", ["raw", "pack_bf16"])
def test_sample_gathers_the_rows_jax_draws(mode, monkeypatch):
    j_mem, t_mem = _pair(mode)
    for step, n in enumerate((4, 5)):
        batch = _transitions(step, n)
        j_mem.push_batch(batch)
        t_mem.push_batch(batch)
    # the indices the JAX buffer draws for its next sample
    _, sub = jax.random.split(j_mem._key)
    idx = np.asarray(jax.random.randint(sub, (6,), 0, jnp.asarray(len(j_mem), jnp.int32)))
    want = j_mem.sample(6)
    _assert_same_tree(jax.tree_util.tree_map(lambda s: s[idx], j_mem.storage), want, "jax gather")
    monkeypatch.setattr(DeviceReplayMemory, "_draw_indices", lambda self, bs: torch.from_numpy(idx.copy()).long())
    _assert_same_tree(t_mem.sample(6), want, f"{mode} sample")


def test_pack_device_features_is_bitwise_the_jax_one():
    rs = np.random.RandomState(0)
    for frames in (0, 4):
        obs = _obs(rs, 7, 0)
        obs["rgb"][1:] = (np.arange(6 * 3 * N_POINTS) % 256).astype(np.uint8).reshape(6, 3, N_POINTS)  # every colour
        obs["xyz"] = obs["xyz"] * 10.0 ** rs.uniform(-3, 2, (7, 3, 1)).astype(np.float32)
        synth = (frames, N_POINTS // frames) if frames else None
        want = j_obs_transfer.pack_device_features(obs, jnp.bfloat16, synth_pos=synth)
        got = pack_device_features({k: torch.from_numpy(v) for k, v in obs.items()}, torch.bfloat16, synth_pos=synth)
        assert got["pcd"].dtype == torch.bfloat16 and got["pcd"].is_contiguous()
        np.testing.assert_array_equal(got["pcd"].view(torch.int16).numpy(),
                                      np.asarray(want["pcd"]).view(np.int16))
        np.testing.assert_array_equal(got["state"].numpy(), np.asarray(want["state"]))
    np.testing.assert_array_equal(synth_pos_encoding(3, 4).numpy(), np.asarray(j_obs_transfer.synth_pos_encoding(3, 4)))


def test_port_draws_and_interface(tmp_path):
    mem = build_replay(dict(type="DeviceReplayMemory", capacity=CAPACITY, transfer_cfg=dict(pack_features=True)),
                       dict(seed=0, device="cpu"))
    assert isinstance(mem, DeviceReplayMemory) and mem.storage is None
    assert replay_summary(mem)["storage_bytes"] == 0
    with pytest.raises(ValueError, match="empty"):
        mem.sample(2)
    mem.push_batch(_transitions(0, 3))
    assert mem.storage["obs"]["pcd"].device.type == "cpu"
    seen = set()
    for _ in range(20):
        idx = mem._draw_indices(8)
        assert int(idx.min()) >= 0 and int(idx.max()) < 3
        seen |= set(idx.tolist())
    assert seen == {0, 1, 2}
    # the replay's seed fixes its draws
    a, b, c = (DeviceReplayMemory(CAPACITY, seed=s, device="cpu") for s in (4, 4, 5))
    for m in (a, b, c):
        m.push_batch(_transitions(1, CAPACITY))
    draws = [m._draw_indices(32) for m in (a, b, c)]
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    batch = mem.sample(5)
    assert batch["obs"]["pcd"].shape == (5, N_POINTS, 8) and batch["dones"].dtype == torch.bool
    # the snapshot file: storage order, read back into a fresh ring bitwise
    mem.to_hdf5(str(tmp_path / "x.h5"))
    back = DeviceReplayMemory(CAPACITY, transfer_cfg=dict(pack_features=True), device="cpu")
    back.load_hdf5(str(tmp_path / "x.h5"), chunk=2)
    assert len(back) == len(mem) == 3
    assert torch.equal(back.storage["obs"]["pcd"][:3].view(torch.int16), mem.storage["obs"]["pcd"][:3].view(torch.int16))
    # a data-parallel rank's replica stays on the rank's device: here the CPU, where it is
    mem.place_on(torch.device("cpu"))
    assert mem.device.type == "cpu" and mem.storage["obs"]["pcd"].device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            mem.place_on("cuda")
    with pytest.raises(ValueError, match="pack_features"):
        DeviceReplayMemory(4, transfer_cfg=dict(pack_features="nonsense"), device="cpu")


def test_build_replay_gives_the_device_only_to_the_device_replay():
    host = build_replay(dict(type="ReplayMemory", capacity=CAPACITY), dict(seed=0), device="cpu")
    assert type(host).__name__ == "ReplayMemory" and replay_summary(host)["device"] == "cpu"
    dev = build_replay(dict(type="DeviceReplayMemory", capacity=CAPACITY), dict(seed=0), device=torch.device("cpu"))
    assert isinstance(dev, DeviceReplayMemory) and dev.device == torch.device("cpu")
    assert build_replay(None, dict(seed=0), device="cpu") is None


def test_cuda_storage_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceReplayMemory(4)
