"""The port's voxel path against the JAX package's: the masked reductions,
the voxelizers, the sparse conv and ``VoxelCNN`` (dense and sparse), on
the same numpy inputs, with the JAX parameters brought across by
``params_from_jax``.

Tolerances: integer outputs (coordinates, occupancy, validity) must be
equal; f32 values agree to 1e-5 (sums in another order over a few
layers); parameter gradients to 1e-4 of each gradient's largest element
(the backward adds a few more sums in another order, through LayerNorms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_rl_torch.convert import params_from_jax
from pointcloud_rl_torch.models import build_all as t_build_all
from pointcloud_rl_torch.ops import masked as t_masked
from pointcloud_rl_torch.ops import sparse_conv as t_sc
from pointcloud_rl_torch.ops import voxelize as t_vox
from pointcloud_rl_tpu.models import build_all as j_build_all
from pointcloud_rl_tpu.ops import masked as j_masked
from pointcloud_rl_tpu.ops import sparse_conv as j_sc
from pointcloud_rl_tpu.ops import voxelize as j_vox

torch.set_num_threads(1)

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = 1e-4  # of the largest element of each gradient


def _cloud(seed, B=2, N=64, extent=1.2, C=5):
    """xyz in [-0.3, extent - 0.3) (with the min-shift, up to ``extent`` of
    cells at 0.1) and features."""
    rs = np.random.RandomState(seed)
    xyz = (rs.rand(B, N, 3) * extent - 0.3).astype(np.float32)
    feat = rs.randn(B, N, C).astype(np.float32)
    return xyz, feat


def _valid(seed, B=2, N=64, frac=0.8):
    return np.random.RandomState(seed + 100).rand(B, N) < frac


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_grads(t_grads, j_grads, names=None):
    for name in names or t_grads:
        got, want = t_grads[name].numpy(), np.asarray(j_grads[name])
        scale = np.abs(want).max() + 1e-12
        assert np.abs(got - want).max() <= GRAD_RTOL * scale, f"{name}: {np.abs(got - want).max()} vs scale {scale}"


@pytest.mark.parametrize("empty", [False, True], ids=["some_valid", "row_empty"])
def test_masked_reductions_match_jax(empty):
    rs = np.random.RandomState(0)
    x = rs.randn(3, 7, 4).astype(np.float32)
    mask = rs.rand(3, 7, 1) < 0.5
    if empty:
        mask[1] = False
    for ev in (0.0, -2.5):
        np.testing.assert_array_equal(t_masked.masked_max(_t(x), _t(mask), empty_value=ev).numpy(),
                                      np.asarray(j_masked.masked_max(x, mask, empty_value=ev)))
    np.testing.assert_allclose(t_masked.masked_average(_t(x), _t(mask)).numpy(),
                               np.asarray(j_masked.masked_average(x, mask)), **FWD_TOL)
    if empty:
        assert (t_masked.masked_max(_t(x), _t(mask), empty_value=-2.5)[1] == -2.5).all()


@pytest.mark.parametrize("grid_size", [None, (8, 8, 8), (5, 9, 7)], ids=["no_grid", "grid8", "grid_odd"])
def test_compute_voxel_coords_matches_jax(grid_size):
    xyz, _ = _cloud(1)
    want = np.asarray(j_vox.compute_voxel_coords(xyz, 0.1, grid_size=grid_size))
    got = t_vox.compute_voxel_coords(_t(xyz), 0.1, grid_size=grid_size)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    origin = np.full((2, 1, 3), -0.5, np.float32)
    np.testing.assert_array_equal(t_vox.compute_voxel_coords(_t(xyz), 0.1, _t(origin), grid_size).numpy(),
                                  np.asarray(j_vox.compute_voxel_coords(xyz, 0.1, origin, grid_size)))


@pytest.mark.parametrize("masked", [False, True], ids=["all_valid", "valid_mask"])
@pytest.mark.parametrize("grid_size", [(8, 8, 8), (15, 16, 17)], ids=["grid8_clipped", "grid_odd"])
def test_voxelize_dense_matches_jax(grid_size, masked):
    """Points past an 8-grid (the cloud spans 12 cells) are clipped into it."""
    xyz, feat = _cloud(2)
    valid = _valid(2) if masked else None
    j_grid, j_occ = j_vox.voxelize_dense(xyz, feat, 0.1, grid_size, valid_mask=valid)
    t_grid, t_occ = t_vox.voxelize_dense(_t(xyz), _t(feat), 0.1, grid_size,
                                         valid_mask=None if valid is None else _t(valid))
    np.testing.assert_array_equal(t_occ.numpy(), np.asarray(j_occ))
    np.testing.assert_allclose(t_grid.numpy(), np.asarray(j_grid), **FWD_TOL)


@pytest.mark.parametrize("capacity", [64, 20], ids=["room", "overflow"])
@pytest.mark.parametrize("masked", [False, True], ids=["all_valid", "valid_mask"])
def test_voxelize_sparse_matches_jax(masked, capacity):
    """``overflow``: fewer slots than occupied voxels; the cloud spans up to
    40 cells, so the 10-bit keys see coordinates far past any grid."""
    xyz, feat = _cloud(3, extent=4.0)
    valid = _valid(3) if masked else None
    want = j_vox.voxelize_sparse(xyz, feat, 0.1, capacity, valid_mask=valid)
    got = t_vox.voxelize_sparse(_t(xyz), _t(feat), 0.1, capacity, valid_mask=None if valid is None else _t(valid))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **FWD_TOL)
    if capacity == 20:
        assert bool(got[2].all())  # every slot taken, the rest dropped


def _sparse_table(seed, capacity=48, C=6):
    xyz, feat = _cloud(seed, N=64, extent=1.0, C=C)
    return j_vox.voxelize_sparse(xyz, feat, 0.1, capacity)


@pytest.mark.parametrize("stride", [1, 2])
def test_downsample_sites_matches_jax(stride):
    _, coords, valid = _sparse_table(4)
    want = j_sc.downsample_sites(coords, valid, stride, 48)
    got = t_sc.downsample_sites(_t(coords), _t(valid), stride, 48)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sparse_conv_layer_matches_jax_with_gradients():
    feat, coords, valid = (np.asarray(a) for a in _sparse_table(5))
    rs = np.random.RandomState(6)
    w = (rs.randn(64, 6, 10) * 0.2).astype(np.float32)
    b = rs.randn(10).astype(np.float32)
    proj = rs.randn(2, 48, 10).astype(np.float32)

    def j_loss(feat, w, b):
        out, _, _ = j_sc.sparse_conv_layer(feat, coords, valid, w, b)
        return jnp.sum(out * proj)

    j_out, j_oc, j_ov = j_sc.sparse_conv_layer(feat, coords, valid, w, b)
    j_g = jax.grad(j_loss, argnums=(0, 1, 2))(feat, w, b)
    leaves = [_t(a).clone().requires_grad_(True) for a in (feat, w, b)]
    out, oc, ov = t_sc.sparse_conv_layer(leaves[0], _t(coords), _t(valid), leaves[1], leaves[2])
    np.testing.assert_array_equal(oc.numpy(), np.asarray(j_oc))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(j_ov))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **FWD_TOL)
    (out * _t(proj)).sum().backward()
    _close_grads({k: t.grad for k, t in zip("fwb", leaves)}, dict(zip("fwb", j_g)))


def _voxel_obs(seed, B=2, N=96):
    """An {xyz, rgb uint8, seg} cloud over 1.2 m (12 cells at 0.1)."""
    rs = np.random.RandomState(seed)
    return {
        "xyz": (rs.rand(B, 3, N) * 1.2).astype(np.float32),
        "rgb": rs.randint(0, 256, (B, 3, N)).astype(np.uint8),
        "seg": (rs.rand(B, 2, N) < 0.3).astype(np.float32),
    }


def numpy_params(j_net, example, seed=0):
    """A parameter tree of ``j_net``'s structure filled from a numpy seed:
    kernels U(+-1/sqrt(fan_in)), biases U(+-0.1), LayerNorm scales and VN
    gains 1 + 0.1 N(0, 1).  (Tracing the init is enough for the structure;
    compiling it on the CPU would take seconds per model.)"""
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(j_net.init, {"params": jax.random.PRNGKey(0)}, example)["params"]

    def fill(path, leaf):
        name = str(path[-1].key)
        if name in ("scale", "gain"):
            value = 1.0 + 0.1 * rs.randn(*leaf.shape)
        elif name.endswith("bias"):
            value = rs.uniform(-0.1, 0.1, leaf.shape)
        else:
            bound = 1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
            value = rs.uniform(-bound, bound, leaf.shape)
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def model_pair(cfg, example, seed=0):
    """The JAX and the port's module of ``cfg`` on one numpy-made parameter
    set, brought across by ``params_from_jax``."""
    j_net = j_build_all(cfg)
    params = numpy_params(j_net, example, seed)
    t_net = t_build_all(cfg, generator=torch.Generator().manual_seed(0))
    sd = params_from_jax(params)
    assert sorted(sd) == sorted(t_net.state_dict())
    t_net.load_state_dict(sd)
    return j_net, params, t_net


def check_output_and_grads(j_net, params, t_net, obs, out_dim):
    """Output and every parameter's gradient of a fixed weighted sum of it."""
    proj = np.random.RandomState(2).randn(len(next(iter(obs.values()))), out_dim).astype(np.float32)
    want, vjp = jax.vjp(jax.jit(lambda p: j_net.apply({"params": p}, obs)), params)
    j_grads = vjp(jnp.asarray(proj))[0]
    got = t_net({k: _t(v) for k, v in obs.items()})
    assert tuple(got.shape) == proj.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD_TOL)
    (got * _t(proj)).sum().backward()
    _close_grads({k: p.grad for k, p in t_net.named_parameters()}, params_from_jax(j_grads))


def voxel_pair(impl, grid_size=(8, 8, 8), seed=0):
    cfg = dict(type="SparseCNN", in_channels=8, out_channels=12, voxel_size=0.1, mlp_spec=[8, 12, 16],
               stem_channels=[8, 8], grid_size=grid_size, impl=impl)
    return model_pair(cfg, _voxel_obs(0), seed)


@pytest.mark.parametrize("grid_size", [(8, 8, 8), (15, 16, 17)], ids=["grid8", "grid_odd"])
@pytest.mark.parametrize("impl", ["dense", "sparse"])
def test_voxel_cnn_matches_jax_with_gradients(impl, grid_size):
    """Output and every parameter's gradient of a weighted sum of it.  The
    sparse path ignores ``grid_size``; its capacity is the point count."""
    check_output_and_grads(*voxel_pair(impl, grid_size), _voxel_obs(1), 12)


@pytest.mark.parametrize("n, want", [(32, (1, 1)), (8, (1, 1)), (15, (1, 2)), (17, (1, 2)), (3, (1, 2)), (1, (1, 2))])
def test_same_padding_is_flax_same(n, want):
    """flax's SAME padding for k=4, s=2: ceil(n / 2) outputs, asymmetric on odd sizes."""
    from pointcloud_rl_torch.models.voxel import same_padding

    assert same_padding(n, 4, 2) == want
    lo, hi = want
    assert (n + lo + hi - 4) // 2 + 1 == -(-n // 2)
