"""The port's device point-cloud ops against the JAX package's.

``dmc_raw_to_pointcloud`` (``ops/obs_fuse.py``), ``fuse_camera_pointclouds``
and its parts (``ops/camera.py``), ``seg_balanced_downsample`` and
``uniform_downsample`` (``ops/sampling.py``): the same numpy inputs, and
the uniforms JAX draws from its key injected into the port's functions
(``draws=``), so the two sides make the same choices.

Tolerances: the fusion's xyz within 1e-5 absolute (JAX unprojects with two
f32 matmuls, the port with separately rounded products and sums in index
order: a few ulps of O(1) coordinates); everything chosen (which points,
their colours, the frame channel, sampling indices) identical.  Camera
fusion: one f32 einsum each side, 1e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_rl_torch.ops import (depth_to_camera_xyz, fuse_camera_pointclouds, seg_balanced_downsample,
                                     transform_points, uniform_downsample)
from pointcloud_rl_torch.ops.obs_fuse import dmc_raw_to_pointcloud
from pointcloud_rl_tpu.ops import camera as j_camera
from pointcloud_rl_tpu.ops import sampling as j_sampling
from pointcloud_rl_tpu.ops.obs_fuse import dmc_raw_to_pointcloud as j_fuse

torch.set_num_threads(1)

XYZ_ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_fuse_draws(key, B, S, n):
    """The (body, ground) uniforms ``[B, S, n]`` JAX's fusion draws from ``key``."""
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(B * S)).reshape(B, S, -1)

    def one(k):
        kb, kg = jax.random.split(k)
        return jax.random.uniform(kb, (n,)), jax.random.uniform(kg, (n,))

    body, ground = jax.vmap(jax.vmap(one))(keys)
    return _t(body), _t(ground)


def _raw(seed, B=3, S=2, H=16, W=20, far=0.2):
    """Depth (a share ``far`` beyond max_depth), rgb and camera rows: random
    rotations, camera heights in [0.5, 1.5]."""
    rs = np.random.RandomState(seed)
    depth = rs.uniform(0.5, 4.5, (B, S, H, W)).astype(np.float32)
    depth[rs.rand(B, S, H, W) < far] = 9.0
    rgb = rs.randint(0, 256, (B, 3 * S, H, W)).astype(np.uint8)
    cam = np.zeros((B, S, 1, 12), np.float32)
    for b in range(B):
        for s in range(S):
            cam[b, s, 0, :9] = np.linalg.qr(rs.randn(3, 3))[0].reshape(-1)
            cam[b, s, 0, 9] = rs.uniform(0.5, 1.5)
    k = np.array([[18.0, 0, (W - 1) / 2], [0, 18.0, (H - 1) / 2], [0, 0, 1.0]])
    return depth, rgb, cam, np.linalg.inv(k).astype(np.float32)


def _both(depth, rgb, cam, inv_k, key_seed=0, **kw):
    key = jax.random.PRNGKey(key_seed)
    want = {k: np.asarray(v) for k, v in j_fuse(key, depth, rgb, cam, inv_k, **kw).items()}
    B, S, H, W = depth.shape
    got = dmc_raw_to_pointcloud(_t(depth), _t(rgb), _t(cam), _t(inv_k), draws=_jax_fuse_draws(key, B, S, H * W), **kw)
    return want, {k: v.numpy() for k, v in got.items()}


def _check(want, got):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    np.testing.assert_allclose(got["xyz"], want["xyz"], rtol=0, atol=XYZ_ATOL)
    np.testing.assert_array_equal(got["rgb"], want["rgb"])
    np.testing.assert_array_equal(got["pos_encoding"], want["pos_encoding"])


# ground_eps 0.3 puts a share of the random heights on each side
@pytest.mark.parametrize("z_to_world, fix_base_z", [(True, None), (False, None), (True, 0.2)],
                         ids=["z_to_world", "camera_z", "fix_base_z"])
def test_fusion_matches_jax(z_to_world, fix_base_z):
    depth, rgb, cam, inv_k = _raw(0)
    want, got = _both(depth, rgb, cam, inv_k, n_points=48, num_ground=16, ground_eps=0.3, max_depth=5.0,
                      z_to_world=z_to_world, fix_base_z=fix_base_z)
    _check(want, got)
    assert got["xyz"].shape == (3, 3, 2 * 48) and np.abs(got["xyz"]).max() > 0


def test_fusion_pads_by_tiling_when_a_side_is_short():
    # 40 valid pixels for 128 points: both sides tile their members
    depth, rgb, cam, inv_k = _raw(1, B=2, S=1, H=8, W=8, far=0.4)
    want, got = _both(depth, rgb, cam, inv_k, key_seed=3, n_points=128, num_ground=32, ground_eps=0.3,
                      max_depth=5.0, z_to_world=True)
    _check(want, got)


@pytest.mark.parametrize("empty", ["body", "ground", "all"])
def test_fusion_zero_fills_an_empty_side(empty):
    """No body pixels, no ground pixels (a fixed base z under every point),
    no valid pixel at all: the empty side, or everything, is zeros."""
    H = W = 8
    inv_k = np.eye(3, dtype=np.float32)
    cam = np.zeros((2, 1, 1, 12), np.float32)
    cam[..., :9] = np.eye(3, dtype=np.float32).reshape(-1)
    rgb = np.full((2, 3, H, W), 200, np.uint8)
    depth = np.random.RandomState(2).uniform(0.5, 2.0, (2, 1, H, W)).astype(np.float32)
    kw = dict(n_points=32, num_ground=8, ground_eps=1e-2, max_depth=5.0, z_to_world=False)
    if empty == "body":
        cam[..., :9] = np.diag([1.0, 1.0, 0.0]).astype(np.float32).reshape(-1)  # every height 0: all ground
    elif empty == "ground":
        kw["fix_base_z"] = -10.0
    else:
        depth[:] = 9.0
    want, got = _both(depth, rgb, cam, inv_k, **kw)
    _check(want, got)
    xyz, col = got["xyz"].transpose(0, 2, 1), got["rgb"].transpose(0, 2, 1)
    side = {"body": slice(0, 24), "ground": slice(24, 32), "all": slice(0, 32)}[empty]
    assert (xyz[:, side] == 0).all() and (col[:, side] == 0).all()
    if empty != "all":
        other = slice(24, 32) if empty == "body" else slice(0, 24)
        assert (col[:, other] == 200).all()


def test_fusion_generator_draws_are_the_generators():
    depth, rgb, cam, inv_k = _raw(4)
    args = (_t(depth), _t(rgb), _t(cam), _t(inv_k))
    kw = dict(n_points=40, num_ground=8, ground_eps=0.3, max_depth=5.0, z_to_world=True)
    a = dmc_raw_to_pointcloud(*args, generator=torch.Generator().manual_seed(5), **kw)
    g = torch.Generator().manual_seed(5)
    draws = tuple(torch.rand((3, 2, 16 * 20), generator=g) for _ in range(2))
    b = dmc_raw_to_pointcloud(*args, draws=draws, **kw)
    c = dmc_raw_to_pointcloud(*args, generator=torch.Generator().manual_seed(6), **kw)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["xyz"], c["xyz"])


# ----------------------------------------------------------------- camera
def _cameras(seed, B=2, C=3, H=12, W=10):
    rs = np.random.RandomState(seed)
    depths = rs.uniform(0.3, 4.0, (B, C, H, W)).astype(np.float32)
    rgbs = rs.randint(0, 256, (B, C, H, W, 3)).astype(np.uint8)
    K = np.array([[15.0, 0, (W - 1) / 2], [0, 16.0, (H - 1) / 2], [0, 0, 1]], np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (B, C, 1, 1))
    for b in range(B):
        for c in range(C):
            poses[b, c, :3, :3] = np.linalg.qr(rs.randn(3, 3))[0]
            poses[b, c, :3, 3] = rs.randn(3)
    segs = rs.rand(B, C, H, W, 2) > 0.5
    return depths, rgbs, K, poses, segs


@pytest.mark.parametrize("per_env_k", [False, True], ids=["shared_k", "per_env_k"])
def test_fuse_camera_pointclouds_matches_jax(per_env_k):
    depths, rgbs, K, poses, segs = _cameras(0)
    Ks = np.broadcast_to(K, (2, 3, 3, 3)).copy() if per_env_k else np.broadcast_to(K, (3, 3, 3)).copy()
    want = j_camera.fuse_camera_pointclouds(*map(jnp.asarray, (depths, rgbs, Ks, poses, segs)))
    got = fuse_camera_pointclouds(*map(_t, (depths, rgbs, Ks, poses, segs)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=XYZ_ATOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert fuse_camera_pointclouds(*map(_t, (depths, rgbs, Ks, poses)))[2] is None


def test_camera_parts_match_jax():
    depths, _, K, poses, _ = _cameras(1)
    want = np.asarray(j_camera.depth_to_camera_xyz(jnp.asarray(depths), jnp.asarray(K)))
    got = depth_to_camera_xyz(_t(depths), _t(K)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=XYZ_ATOL)
    np.testing.assert_allclose(got[..., 2], depths.reshape(2, 3, -1), rtol=1e-6)  # z = depth
    pts = np.random.RandomState(2).randn(2, 3, 10, 3).astype(np.float32)
    np.testing.assert_allclose(transform_points(_t(pts), _t(poses)).numpy(),
                               np.asarray(j_camera.transform_points(jnp.asarray(pts), jnp.asarray(poses))),
                               rtol=0, atol=XYZ_ATOL)


# --------------------------------------------------------------- sampling
def _scene(B=3, n=2000, seed=0):
    """tests/test_device_sampling.py's scene: a ground band, a segment
    smaller than min_pts and a large one."""
    rs = np.random.RandomState(seed)
    xyz = (rs.rand(B, n, 3) + [0, 0, 0.4]).astype(np.float32)
    xyz[:, -200:, 2] = 1e-4
    seg = np.zeros((B, n, 2), bool)
    seg[:, :25, 0] = True
    seg[:, 25:1200, 1] = True
    return xyz, seg


@pytest.mark.parametrize("n_points, min_pts, fg_pts", [(600, 25, 400), (1900, 50, 800), (128, 10, 90)])
def test_seg_balanced_downsample_matches_jax(n_points, min_pts, fg_pts):
    xyz, seg = _scene()
    key = jax.random.PRNGKey(7)
    want = np.asarray(j_sampling.seg_balanced_downsample(key, jnp.asarray(xyz), jnp.asarray(seg), n_points,
                                                         min_pts=min_pts, fg_pts=fg_pts))
    draws = (_t(jax.random.uniform(key, (3, 2000, 3))), _t(jax.random.uniform(jax.random.fold_in(key, 1), (3, 2000))))
    got = seg_balanced_downsample(_t(xyz), _t(seg), n_points, min_pts=min_pts, fg_pts=fg_pts, draws=draws)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (np.take_along_axis(xyz[..., 2], got.numpy(), 1) > 1e-3).all()


@pytest.mark.parametrize("ground_eps", [1e-3, None], ids=["ground_filter", "no_filter"])
def test_uniform_downsample_matches_jax(ground_eps):
    xyz, _ = _scene(B=2, n=300, seed=1)
    xyz[:, :250, 2] = 0.0  # 50 valid points for 128: tiled
    key = jax.random.PRNGKey(2)
    want = np.asarray(j_sampling.uniform_downsample(key, jnp.asarray(xyz), 128, ground_eps=ground_eps))
    got = uniform_downsample(_t(xyz), 128, ground_eps=ground_eps, draws=_t(jax.random.uniform(key, (2, 300))))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampling_with_a_generator_keeps_the_invariants():
    xyz, seg = _scene(seed=3)
    idx = seg_balanced_downsample(_t(xyz), _t(seg), 600, min_pts=25, fg_pts=400,
                                  generator=torch.Generator().manual_seed(0)).numpy()
    assert idx.shape == (3, 600)
    assert (np.take_along_axis(xyz[..., 2], idx, 1) > 1e-3).all()
    tiny = np.take_along_axis(seg[..., 0], idx, 1)
    assert all(np.unique(idx[b][tiny[b]]).size == 25 for b in range(3))
    assert not np.array_equal(idx[0], idx[1])
