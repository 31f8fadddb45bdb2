"""The port's augmentations against the JAX package's, on the same data.

Each JAX augmentation runs eagerly on numpy data with a PRNG key, and its
random draws are recorded (the output of ``sample_info``, or the draw an
``apply_single`` makes); the port's class then runs on the same data with
those draws injected into its ``sample_info`` / ``_draw_*`` method, so
both sides apply the same transform.  f32 outputs agree to 1e-6 (sums in
another order); gathers, paddings and permutations agree exactly.  The
port's own draws are checked for their bounds and their sharing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_rl_torch.ops import augment as ta
from pointcloud_rl_tpu.ops import augment as ja

torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-6, atol=1e-6)
# bf16 storage: an f32 value that differs in its last bits may round to the
# neighbouring bf16 value, one ulp = 2^-8 of the value.
BF16_TOL = dict(rtol=2 ** -7, atol=1e-6)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if tree is None:
        return None
    return torch.from_numpy(np.array(tree))


def _to_np(tree):
    if isinstance(tree, dict):
        return {k: _to_np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy() if tree.dtype == torch.bfloat16 else tree.numpy()
    return np.asarray(tree.astype(jnp.float32) if tree.dtype == jnp.bfloat16 else tree)


def _assert_tree_close(got, want, tol=F32_TOL):
    got, want = _to_np(got), _to_np(want)
    assert sorted(got) == sorted(want)
    for key in want:
        if isinstance(want[key], dict):
            _assert_tree_close(got[key], want[key], tol)
            continue
        assert got[key].shape == want[key].shape, key
        assert got[key].dtype == want[key].dtype, (key, got[key].dtype, want[key].dtype)
        if tol is None:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want[key], **tol, err_msg=key)


def _record(monkeypatch, cls, name, capture=None):
    """Wrap the JAX ``cls.name`` to record ``capture(self, *args)`` (default:
    its return value) at every call."""
    calls = []
    orig = getattr(cls, name)

    def wrapper(self, *args):
        out = orig(self, *args)
        calls.append(out if capture is None else capture(self, orig, *args))
        return out

    monkeypatch.setattr(cls, name, wrapper)
    return calls


def _inject(monkeypatch, cls, name, values, convert):
    """Make the port's ``cls.name`` return the recorded ``values`` (a list
    the JAX run fills) in turn."""
    used = []

    def replay(self, *args, **kwargs):
        used.append(None)
        return convert(values[len(used) - 1])

    monkeypatch.setattr(cls, name, replay)


def _scene(seed, B=4, N=50):
    rs = np.random.RandomState(seed)
    return {
        "xyz": rs.randn(B, 3, N).astype(np.float32),
        "rgb": rs.randint(0, 256, (B, 3, N)).astype(np.uint8),
        "seg": (rs.rand(B, 2, N) < 0.3).astype(np.float32),
        "state": {
            "ee_pos": rs.randn(B, 3).astype(np.float32),
            "ee_vel": rs.randn(B, 3).astype(np.float32),
            "base_vel": rs.randn(B, 2).astype(np.float32),
        },
    }


def _run_pair(j_aug, t_aug, data, seed=0):
    want = j_aug(jax.random.PRNGKey(seed), data)
    got = t_aug(torch.Generator().manual_seed(seed), _to_torch(data))
    return got, want


def _rot_info(info):
    rot, delta = info
    return (None if rot is None else _to_torch(rot)), _to_torch(delta)


GRST_CASES = {
    "rot_scale_trans": dict(translation_range=(0.1, 0.2, 0.3)),
    "shift_height": dict(translation_range=(0.1, 0.2, 0.3), shift_height=True),
    "trans_only": dict(rot_range=None, scale_ratio_range=None, translation_range=(0.2, 0.2, 0.2)),
    "rot_x_no_scale": dict(rot_axis="x", scale_ratio_range=None, rot_range=0.5),
    "no_trans": dict(translation_range=None),
}


@pytest.mark.parametrize("case", sorted(GRST_CASES))
def test_global_rot_scale_trans_matches_jax(case, monkeypatch):
    kw = dict(req_keys=["xyz", "state/ee_pos", "state/ee_vel", "state/base_vel"], **GRST_CASES[case])
    infos = _record(monkeypatch, ja.GlobalRotScaleTrans, "sample_info")
    _inject(monkeypatch, ta.GlobalRotScaleTrans, "sample_info", infos, _rot_info)
    got, want = _run_pair(ja.GlobalRotScaleTrans(**kw), ta.GlobalRotScaleTrans(**kw), _scene(1))
    assert len(infos) == 1
    _assert_tree_close(got, want)


@pytest.mark.parametrize("req_keys", [None, ["xyz", "state/ee_pos"]], ids=["main_key", "two_keys"])
def test_random_jitter_points_matches_jax(req_keys, monkeypatch):
    noise = _record(monkeypatch, ja.RandomJitterPoints, "apply_single",
                    capture=lambda self, orig, data, key, info, rng: orig(self, np.zeros_like(data), key, info, rng))
    _inject(monkeypatch, ta.RandomJitterPoints, "_draw_noise", noise, _to_torch)
    kw = dict(req_keys=req_keys, jitter_range=(-0.05, 0.02))
    got, want = _run_pair(ja.RandomJitterPoints(**kw), ta.RandomJitterPoints(**kw), _scene(2))
    assert len(noise) == (1 if req_keys is None else 2)
    _assert_tree_close(got, want)


@pytest.mark.parametrize("kw", [dict(drop_ratio=0.3), dict(max_num_points=30), dict(drop_ratio=0.5, fixed_ratio=False)],
                         ids=["drop_ratio", "max_points", "random_count"])
def test_random_downsample_matches_jax(kw, monkeypatch):
    infos = _record(monkeypatch, ja.RandomDownSample, "sample_info")

    def convert(info):
        index, keep = info
        return torch.from_numpy(np.array(index)).long(), (None if keep is None else torch.tensor(int(keep)))

    _inject(monkeypatch, ta.RandomDownSample, "sample_info", infos, convert)
    kw = dict(req_keys=["xyz", "rgb", "seg"], **kw)
    got, want = _run_pair(ja.RandomDownSample(**kw), ta.RandomDownSample(**kw), _scene(3))
    _assert_tree_close(got, want, tol=None)


def test_random_downsample_and_filter_matches_jax(monkeypatch):
    """Two stacked frames; one row has no foreground in frame 0 (zero-fill)
    and one fewer foreground points than the budget (pad-by-tiling)."""
    scores = _record(monkeypatch, ja.RandomDownSampleAndFilter, "_frame_indices",
                     capture=lambda self, orig, rng, seg: jax.random.uniform(rng, seg.shape))
    _inject(monkeypatch, ta.RandomDownSampleAndFilter, "_draw_scores", scores, _to_torch)
    data = _scene(4)
    rs = np.random.RandomState(5)
    fg = (rs.rand(4, 1, 50) < 0.4).astype(np.float32)
    fg[0, :, :25] = 0.0
    fg[1, :, 25:] = 0.0
    fg[1, :, 25 + 3] = 1.0  # 1 foreground point in frame 1 of row 1
    data["filter_seg"] = fg
    kw = dict(req_keys=("xyz", "rgb"), n_points=10, n_fg=4, stack_frame=2)
    got, want = _run_pair(ja.RandomDownSampleAndFilter(**kw), ta.RandomDownSampleAndFilter(**kw), data)
    assert len(scores) == 2  # one draw per frame
    _assert_tree_close(got, want, tol=None)
    assert got["xyz"].shape == (4, 3, 20)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_color_jitter_points_matches_jax(seed, dtype, monkeypatch):
    infos = _record(monkeypatch, ja.ColorJitterPoints, "sample_info")
    _inject(monkeypatch, ta.ColorJitterPoints, "sample_info", infos,
            lambda info: tuple(_to_torch(v) for v in info))
    data = _scene(seed)
    if dtype == "float32":
        data["rgb"] = data["rgb"].astype(np.float32) / 255.0
    got, want = _run_pair(ja.ColorJitterPoints(), ta.ColorJitterPoints(), data, seed=seed)
    if dtype == "float32":
        _assert_tree_close(got, want)
    else:
        # (x * 255 + 0.5) truncated: an f32 ulp may cross the integer boundary
        diff = np.abs(got["rgb"].numpy().astype(int) - np.asarray(want["rgb"]).astype(int))
        assert diff.max() <= 1 and (diff == 0).mean() > 0.99
        assert got["rgb"].dtype == torch.uint8


def test_add_origin_ball_matches_jax(monkeypatch):
    data = _scene(6)
    want = ja.AddOriginBall(n_pts=7)(jax.random.PRNGKey(0), data)
    ball = np.asarray(want["xyz"])[..., 50:]
    _inject(monkeypatch, ta.AddOriginBall, "_draw_ball", [ball], _to_torch)
    got = ta.AddOriginBall(n_pts=7)(torch.Generator().manual_seed(0), _to_torch(data))
    _assert_tree_close(got, want, tol=None)


def test_channel_first_and_last_match_jax():
    rs = np.random.RandomState(7)
    data = {"rgb": rs.rand(2, 8, 9, 6).astype(np.float32), "depth": {"d": rs.rand(2, 8, 9, 1).astype(np.float32)}}
    for j_cls, t_cls in ((ja.ToChannelFirst, ta.ToChannelFirst), (ja.ToChannelLast, ta.ToChannelLast)):
        got, want = _run_pair(j_cls(), t_cls(), data)
        _assert_tree_close(got, want, tol=None)


@pytest.mark.parametrize("independent", [False, True], ids=["shared", "independent"])
def test_random_channel_swap_matches_jax(independent, monkeypatch):
    def draws(self, orig, data, key, info, rng):
        k_sign, k_perm = jax.random.split(rng)
        n_draw = data.shape[-3] // 3 if self.independent else 1
        do = jax.random.uniform(k_sign, (data.shape[0], n_draw)) <= self.prob
        return do, jax.random.permutation(k_perm, 3)

    recorded = _record(monkeypatch, ja.RandomChannelSwap, "apply_single", capture=draws)
    _inject(monkeypatch, ta.RandomChannelSwap, "_draw_swap", recorded,
            lambda d: (_to_torch(d[0]), _to_torch(d[1]).long()))
    rs = np.random.RandomState(8)
    data = {"rgb": rs.randint(0, 256, (6, 6, 5, 4)).astype(np.uint8)}
    got, want = _run_pair(ja.RandomChannelSwap(independent=independent),
                          ta.RandomChannelSwap(independent=independent), data, seed=3)
    _assert_tree_close(got, want, tol=None)


@pytest.mark.parametrize("mode", ["constant", "reflect", "edge", "symmetric"])
@pytest.mark.parametrize("padding", [2, (1, 3), (1, 2, 3, 0)], ids=["int", "pair", "quad"])
def test_random_crop_matches_jax(mode, padding, monkeypatch):
    infos = _record(monkeypatch, ja.RandomCrop, "sample_info")
    _inject(monkeypatch, ta.RandomCrop, "sample_info", infos,
            lambda info: tuple(_to_torch(v).long() for v in info))
    rs = np.random.RandomState(9)
    data = {"rgb": rs.randint(0, 256, (3, 2, 3, 10, 12)).astype(np.uint8),  # [B, T, C, H, W]
            "depth": rs.rand(3, 2, 1, 10, 12).astype(np.float32)}
    kw = dict(req_keys=("rgb", "depth"), size=8, padding=padding, padding_mode=mode, pad_val=7)
    got, want = _run_pair(ja.RandomCrop(**kw), ta.RandomCrop(**kw), data)
    _assert_tree_close(got, want, tol=None)
    assert tuple(got["rgb"].shape) == (3, 2, 3, 8, 8)


def _compose_cfg():
    return [dict(type="GlobalRotScaleTrans", req_keys=["xyz", "state/ee_pos"], translation_range=(0.1, 0.1, 0.1)),
            dict(type="RandomJitterPoints", main_key="xyz", req_keys=["xyz"], jitter_range=(-0.01, 0.01))]


def _record_and_inject_compose(monkeypatch):
    infos = _record(monkeypatch, ja.GlobalRotScaleTrans, "sample_info")
    _inject(monkeypatch, ta.GlobalRotScaleTrans, "sample_info", infos, _rot_info)
    noise = _record(monkeypatch, ja.RandomJitterPoints, "apply_single",
                    capture=lambda self, orig, data, key, info, rng: orig(self, np.zeros_like(data), key, info, rng))
    _inject(monkeypatch, ta.RandomJitterPoints, "_draw_noise", noise, _to_torch)


def test_data_augmentations_matches_jax(monkeypatch):
    _record_and_inject_compose(monkeypatch)
    j_augs, t_augs = ja.build_data_augmentations(_compose_cfg()), ta.build_data_augmentations(_compose_cfg())
    assert [type(t).__name__ for t in t_augs.transforms] == ["GlobalRotScaleTrans", "RandomJitterPoints"]
    assert ta.build_data_augmentations(None) is None
    got, want = _run_pair(j_augs, t_augs, _scene(10))
    _assert_tree_close(got, want)


def test_apply_augs_to_packed_matches_jax(monkeypatch):
    from pointcloud_rl_tpu.algorithms.obs_transfer import pack_device_features

    _record_and_inject_compose(monkeypatch)
    cfg = _compose_cfg()
    cfg[0]["req_keys"] = ["xyz"]
    j_augs, t_augs = ja.build_data_augmentations(cfg), ta.build_data_augmentations(cfg)
    assert ja.augs_are_xyz_only(j_augs) and ta.augs_are_xyz_only(t_augs) and ta.augs_are_xyz_only(None)
    assert not ta.augs_are_xyz_only(ta.build_data_augmentations(_compose_cfg()))
    scene = _scene(11)
    scene.pop("state")
    packed = pack_device_features(scene, jnp.bfloat16)
    want = ja.apply_augs_to_packed(j_augs, jax.random.PRNGKey(0), packed)
    t_packed = {"pcd": torch.from_numpy(np.array(packed["pcd"].astype(jnp.float32))).bfloat16()}
    got = ta.apply_augs_to_packed(t_augs, torch.Generator().manual_seed(0), t_packed)
    assert got["pcd"].dtype == torch.bfloat16 and tuple(got["pcd"].shape) == (4, 50, 8)
    _assert_tree_close(got, want, tol=BF16_TOL)
    # the channels after xyz pass through untouched
    assert torch.equal(got["pcd"][..., 3:], t_packed["pcd"][..., 3:])


# ------------------------------------------------------- the port's own draws
def test_global_rot_scale_trans_draws_are_in_range_and_shared():
    aug = ta.GlobalRotScaleTrans(req_keys=["xyz", "state/ee_pos", "state/ee_vel"], rot_range=(-0.5, 0.5),
                                 scale_ratio_range=None, translation_range=(0.1, 0.2, 0.3))
    data = _to_torch(_scene(12, B=64))
    data["state"]["ee_pos"] = data["xyz"][:, :, 0].clone()
    data["state"]["ee_vel"] = data["xyz"][:, :, 0].clone()
    rot, delta = aug.sample_info(torch.Generator().manual_seed(0), data["xyz"])
    angle = torch.atan2(rot[:, 1, 0], rot[:, 0, 0])
    assert bool((angle.abs() <= 0.5 + 1e-6).all()) and float(angle.std()) > 0.1  # one angle per element
    assert torch.allclose(rot @ rot.transpose(1, 2), torch.eye(3).expand(64, 3, 3), atol=1e-6)
    assert bool((delta.abs() <= torch.tensor([0.1, 0.2, 0.3])).all()) and bool((delta[:, 2] == 0).all())
    out = aug(torch.Generator().manual_seed(0), data)
    # the same transform reaches every key; "vel" keys are rotated, not shifted
    assert torch.allclose(out["state"]["ee_pos"], out["xyz"][:, :, 0], atol=1e-6)
    assert torch.allclose(out["state"]["ee_vel"] + delta, out["state"]["ee_pos"], atol=1e-6)


def test_shift_height_and_scale_draws():
    xyz = torch.zeros(256, 3, 5)
    aug = ta.GlobalRotScaleTrans(rot_range=None, scale_ratio_range=(0.9, 1.1), translation_range=(0.1, 0.1, 0.1),
                                 shift_height=True)
    rot, delta = aug.sample_info(torch.Generator().manual_seed(1), xyz)
    diag = torch.diagonal(rot, dim1=1, dim2=2)
    assert bool(((diag >= 0.9) & (diag <= 1.1)).all()) and bool((rot - torch.diag_embed(diag) == 0).all())
    assert float(delta[:, 2].abs().max()) > 0.05 and bool((delta.abs() <= 0.1).all())


def test_jitter_and_downsample_draws():
    g = torch.Generator().manual_seed(2)
    data = _to_torch(_scene(13))
    jit = ta.RandomJitterPoints(jitter_range=(-0.01, 0.03))(g, data)
    noise = jit["xyz"] - data["xyz"]
    assert float(noise.min()) >= -0.01 - 1e-6 and float(noise.max()) <= 0.03 + 1e-6 and float(noise.std()) > 1e-3
    assert torch.equal(jit["rgb"], data["rgb"])
    ds = ta.RandomDownSample(req_keys=["xyz", "seg"], drop_ratio=0.4)
    index, _ = ds.sample_info(g, data["xyz"])
    assert len(index) == 30 and len(set(index.tolist())) == 30
    out = ds(g, data)
    assert tuple(out["xyz"].shape) == (4, 3, 30) and tuple(out["seg"].shape) == (4, 2, 30)
    rnd = ta.RandomDownSample(drop_ratio=0.5, fixed_ratio=False)
    for _ in range(5):
        index, keep = rnd.sample_info(g, data["xyz"])
        k = int(keep)
        assert 25 <= k <= 50 and len(index) == 50
        assert len(set(index[:k].tolist())) == k and set(index[k:].tolist()) <= set(index[:k].tolist())


def test_same_generator_state_gives_the_same_transform():
    aug = ta.build_data_augmentations(_compose_cfg())
    data = _to_torch(_scene(14))
    a = aug(torch.Generator().manual_seed(5), data)
    b = aug(torch.Generator().manual_seed(5), data)
    c = aug(torch.Generator().manual_seed(6), data)
    assert torch.equal(a["xyz"], b["xyz"]) and not torch.equal(a["xyz"], c["xyz"])
