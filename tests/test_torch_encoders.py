"""The port's 2D CNN, Vector-Neurons and PointNet-STN encoders against the
JAX package's, on one numpy-made parameter set brought across by
``params_from_jax`` and the same numpy inputs: outputs to 1e-5, every
parameter's gradient to 1e-4 of its largest element (as in
``tests/test_torch_voxel.py``).  Also the structure of the port's
delta-orthogonal init, VN's rotation invariance, and VN on a cloud with
duplicate points.
"""

import os.path as osp
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, osp.dirname(__file__))

from test_torch_voxel import FWD_TOL, _t, check_output_and_grads, model_pair  # noqa: E402

from pointcloud_rl_torch.models import build_all as t_build_all  # noqa: E402

torch.set_num_threads(1)


def _images(seed, B, C, H, W=None):
    rs = np.random.RandomState(seed)
    return {"rgb": rs.randint(0, 256, (B, C, H, W or H)).astype(np.uint8)}


CNNS = {
    "nature": (dict(type="NatureCNN", in_channels=9, image_size=(44, 44), out_channels=24), (9, 44), 24),
    "nature_ln_pad": (dict(type="NatureCNN", in_channels=3, image_size=(20, 20), out_channels=None,
                           mlp_spec=[8, 8], kernel_size=[3, 3], stride=[2, 1], padding=[1, 1],
                           norm_cfg=dict(type="LN2d"), ignore_first_ln=False), (3, 20), 8 * 10 * 10),
    "dmc": (dict(type="DMCEncoder", in_channels=9, image_size=(24, 24), out_channels=10, mlp_spec=[8, 8, 8, 8]),
            (9, 24), 10),
    "dmc_ln_delta_orth": (dict(type="DMCEncoder", in_channels=6, image_size=(21, 21), out_channels=10,
                               mlp_spec=[8, 8, 8, 8], norm_cfg=dict(type="LN2d"),
                               conv_init_cfg=dict(type="delta_orthogonal_init", gain=1.414)), (6, 21), 10),
    "impala": (dict(type="IMPALA", in_channel=3, num_pixels=32 * 32, out_feature_size=16, out_channel=5),
               (3, 32), 5),
}


@pytest.mark.parametrize("name", sorted(CNNS))
def test_cnn_matches_jax_with_gradients(name):
    """The conv stacks, the NHWC flatten order before the first Dense
    (a shape-only check would miss a wrong order), LayerNorms over C."""
    cfg, (c, hw), out_dim = CNNS[name]
    example = _images(0, 2, c, hw)
    check_output_and_grads(*model_pair(cfg, example), _images(1, 2, c, hw), out_dim)


@pytest.mark.parametrize("gain", [1.0, 1.414])
def test_delta_orthogonal_init_structure(gain):
    """DMCEncoder's conv_init_cfg: the central tap of each conv holds a
    matrix with orthonormal rows or columns times the gain; the other taps
    are zero; the biases keep the torch default; the draw is the seed's."""
    cfg = dict(type="DMCEncoder", in_channels=9, image_size=(84, 84), out_channels=50,
               conv_init_cfg=dict(type="delta_orthogonal_init", gain=gain))
    net = t_build_all(cfg, generator=torch.Generator().manual_seed(0))
    again = t_build_all(cfg, generator=torch.Generator().manual_seed(0))
    for i in range(4):
        w = getattr(net, f"Conv_{i}").weight.detach()  # [out, in, 3, 3]
        assert torch.equal(w, getattr(again, f"Conv_{i}").weight)
        centre = w[:, :, 1, 1]
        rest = w.clone()
        rest[:, :, 1, 1] = 0
        assert not rest.any()
        small = min(centre.shape)
        gram = centre.T @ centre if centre.shape[0] >= centre.shape[1] else centre @ centre.T
        torch.testing.assert_close(gram, gain**2 * torch.eye(small), rtol=0, atol=1e-5)
        bound = 1 / np.sqrt(w.shape[1] * 9)
        assert getattr(net, f"Conv_{i}").bias.abs().max() <= bound


def _cloud_obs(seed, B=2, N=40, extra=True):
    rs = np.random.RandomState(seed)
    obs = {"xyz": rs.randn(B, 3, N).astype(np.float32)}
    if extra:
        obs["rgb"] = rs.randint(0, 256, (B, 3, N)).astype(np.uint8)
        obs["seg"] = (rs.rand(B, 2, N) < 0.3).astype(np.float32)
    return obs


VN_CFG = dict(type="VNPointNet", feat_dim=8, mlp_spec=[8, 8, 12], out_channels=10, n_knn=4)


def _duplicated(obs):
    """Every point of the first half repeated in the second half (as
    ``pcd_base`` repeats points of a short segment)."""
    out = {k: v.copy() for k, v in obs.items()}
    n = out["xyz"].shape[-1] // 2
    for v in out.values():
        v[..., n:2 * n] = v[..., :n]
    return out


@pytest.mark.parametrize("cloud", ["general", "duplicates"])
def test_vn_pointnet_matches_jax_with_gradients(cloud):
    """Points in general position pick the same neighbours; with exact
    duplicates, ties go to the lower index (the pick among copies of one
    point cannot change the edge vectors, so values still agree)."""
    obs = _cloud_obs(1)
    if cloud == "duplicates":
        obs = _duplicated(obs)
    check_output_and_grads(*model_pair(VN_CFG, _cloud_obs(0)), obs, 10)


def test_knn_breaks_exact_ties_by_the_lower_index():
    from pointcloud_rl_torch.models.vn import knn_indices
    from pointcloud_rl_tpu.models.vn import knn_indices as j_knn

    # a unit square and its centre: the centre's 4 neighbours tie exactly
    xyz = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0], [0.5, 0.5, 0], [3, 3, 0]]], np.float32)
    got = knn_indices(_t(xyz), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_knn(xyz, 3)))
    assert got[0, 4].tolist() == [0, 1, 2]
    dup = np.concatenate([xyz, xyz], axis=1)
    got = knn_indices(_t(dup), 2)
    assert got[0, :6, 0].tolist() == [6, 7, 8, 9, 10, 11]  # each point's copy first
    assert got[0, 6:, 0].tolist() == [0, 1, 2, 3, 4, 5]


def test_vn_pointnet_is_rotation_invariant():
    _, _, net = model_pair(VN_CFG, _cloud_obs(0))
    obs = _cloud_obs(3)
    a, b, c = 0.3, -1.1, 2.0
    rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]])
    rx = np.array([[1, 0, 0], [0, np.cos(c), -np.sin(c)], [0, np.sin(c), np.cos(c)]])
    rot = (rz @ ry @ rx).astype(np.float32)
    turned = dict(obs, xyz=np.einsum("ij,bjn->bin", rot, obs["xyz"]) + np.float32(0.7))
    with torch.no_grad():
        want = net({k: _t(v) for k, v in obs.items()})
        got = net({k: _t(v) for k, v in turned.items()})
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("transform", [[1], [2], [1, 2]], ids=["stn_xyz", "stn_feature", "both"])
def test_pointnet_feature_transform_matches_jax_with_gradients(transform):
    cfg = dict(type="PointNet", feat_dim=8, mlp_spec=[8, 16, 32], out_channels=12, feature_transform=transform,
               fused=True)
    j_net, params, t_net = model_pair(dict(cfg, fused=False), _cloud_obs(0))
    fused = t_build_all(cfg)
    fused.load_state_dict(t_net.state_dict())
    assert not fused._fused_supported()  # the STN runs on the plain path only
    check_output_and_grads(j_net, params, t_net, _cloud_obs(4), 12)
    with torch.no_grad():
        obs = {k: _t(v) for k, v in _cloud_obs(4).items()}
        np.testing.assert_allclose(fused(obs).numpy(), t_net(obs).numpy(), **FWD_TOL)


@pytest.mark.parametrize("kind", ["VoxelCNN", "SparseCNN", "NatureCNN", "DMCEncoder", "IMPALA", "VNPointNet"])
def test_encoder_type_is_registered_as_in_the_jax_package(kind):
    """Each encoder type of the JAX package's NETWORK registry builds in the
    port from its config (and no longer raises NotImplementedError)."""
    from pointcloud_rl_torch.models import NETWORK
    from pointcloud_rl_tpu.models import NETWORK as J_NETWORK

    assert kind in J_NETWORK.module_dict and kind in NETWORK.module_dict
    cfg = {"VoxelCNN": dict(in_channels=8), "SparseCNN": dict(in_channels=8, impl="sparse"),
           "NatureCNN": dict(in_channels=3, image_size=(36, 36)), "DMCEncoder": dict(in_channels=3, image_size=(36, 36)),
           "IMPALA": dict(in_channel=3, num_pixels=36 * 36), "VNPointNet": dict(feat_dim=3)}[kind]
    net = t_build_all(dict(cfg, type=kind), generator=torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in net.parameters()) > 0
