"""``obs_transfer_cfg`` in the port against the JAX package.

``make_obs_transfer``, ``complete_packed``, ``complete_obs_dict`` and
``pack_pointcloud_obs`` take the same inputs to the same outputs in both
packages.  The act with the pos_encoding block dropped (re-synthesized on
the device), with a float16 upload, and with ``pack_mode="dict"`` gives
the actions of the full-obs act (as ``tests/test_obs_transfer.py`` holds
the JAX package to it) and JAX's actions from the same parameters.  One
SAC update at narrowed widths of the walker recipe (``pn_walker_tpu.py``:
PointNet -> 50 with ``ignore_first_ln``, the obs transfer, stale actor
features) on a ``DeviceReplayMemory`` batch stored without the block
matches JAX's update from converted parameters.

Tolerances: the pos_encoding path is exact (the same f32 values reach the
encoder); float16 xyz moves a coordinate by up to 2^-11 relative, which
the actions feel at the 1e-3 level (5e-3, as the JAX test); the port vs
JAX act from one parameter set: f32 sums in another order (1e-5).
"""

import os.path as osp
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, osp.dirname(__file__))

from test_torch_models import FWD_TOL, jax_leaf  # noqa: E402
from test_torch_sac import _FixedMemory, _pin_noise  # noqa: E402

from pointcloud_rl_torch.algorithms import build_agent as t_build_agent  # noqa: E402
from pointcloud_rl_torch.algorithms import obs_transfer as t_ot  # noqa: E402
from pointcloud_rl_torch.algorithms.base import pack_pointcloud_obs as t_pack  # noqa: E402
from pointcloud_rl_torch.convert import params_from_jax  # noqa: E402
from pointcloud_rl_torch.env.device_replay import DeviceReplayMemory  # noqa: E402
from pointcloud_rl_tpu.algorithms import build_agent as j_build_agent  # noqa: E402
from pointcloud_rl_tpu.algorithms import obs_transfer as j_ot  # noqa: E402
from pointcloud_rl_tpu.algorithms.base import pack_pointcloud_obs as j_pack  # noqa: E402
from pointcloud_rl_tpu.config import Config  # noqa: E402

torch.set_num_threads(1)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
WALKER_CONFIG = osp.join(REPO, "configs/mfrl/sac/dm_control/pn_walker_tpu.py")
F, PPF = 3, 16  # stacked frames, points per frame
N = F * PPF
A = 6
F16_ATOL = 5e-3
METRIC_RTOL = 1e-3  # update metrics: f32 sums in another order (tests/test_torch_sac.py)
LR = 1e-3


class _Box:
    def __init__(self, low, high, shape):
        self.low = np.full(shape, low, np.float32)
        self.high = np.full(shape, high, np.float32)
        self.shape = shape


def _env_params(seg=False):
    shape = {"xyz": (3, N), "rgb": (3, N), "pos_encoding": (F, N)}
    if seg:
        shape["seg"] = (2, N)
    return dict(obs_shape=shape, action_shape=A, is_discrete=False, action_space=_Box(-1.0, 1.0, (A,)))


def _walker_cfg(bf16=False, **transfer):
    """``pn_walker_tpu.py`` resolved against the test obs shapes, with
    PointNet [16, 32, 64] -> 50 and heads of 32 (the recipe's 50-wide
    feature and ``ignore_first_ln`` kept), batch 16."""
    from pointcloud_rl_torch.models import get_kwargs_from_shape, replace_placeholder_with_args

    cfg = Config.fromfile(WALKER_CONFIG)
    cfg.merge_from_dict({
        "agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.mlp_spec": [16, 32, 64],
        "agent_cfg.actor_cfg.nn_cfg.mlp_cfg.mlp_spec": [50, 32, 32, "action_shape * 2"],
        "agent_cfg.critic_cfg.nn_cfg.mlp_cfg.mlp_spec": ["50 + action_shape", 32, 32, 1],
        "agent_cfg.batch_size": 16,
        "agent_cfg.bf16": bf16,
    })
    agent_cfg = dict(cfg["agent_cfg"])
    if transfer:
        agent_cfg["obs_transfer_cfg"] = transfer.get("cfg")
    env_params = _env_params()
    kwargs = get_kwargs_from_shape(env_params["obs_shape"], A)
    agent_cfg = dict(replace_placeholder_with_args(agent_cfg, **kwargs))
    return dict(agent_cfg, env_params=env_params, seed=0)


def _obs(m, seed=0, seg=False):
    rs = np.random.RandomState(seed)
    obs = {
        "xyz": rs.randn(m, 3, N).astype(np.float32),
        "rgb": rs.randint(0, 256, (m, 3, N)).astype(np.uint8),
        "pos_encoding": np.broadcast_to(np.repeat(np.eye(F, dtype=np.uint8), PPF, axis=-1), (m, F, N)).copy(),
    }
    if seg:
        obs["seg"] = (rs.rand(m, 2, N) < 0.3).astype(np.float32)
    return obs


# ------------------------------------------------------------------ spec
@pytest.mark.parametrize("cfg", [
    dict(pos_encoding_on_device=True),
    dict(pos_encoding_on_device=True, pack_dtype="float16"),
    dict(pos_encoding_on_device=False, pack_dtype="float16"),
    dict(pos_encoding_on_device=True, pack_mode="dict"),
    dict(pack_dtype="float16", pack_mode="dict"),
    None,
], ids=["pos", "pos_f16", "f16_only", "dict", "dict_f16", "off"])
@pytest.mark.parametrize("shape", ["stacked", "stacked_seg", "no_pos_encoding"])
def test_make_obs_transfer_matches_jax(cfg, shape):
    obs_shape = {"stacked": _env_params()["obs_shape"], "stacked_seg": _env_params(seg=True)["obs_shape"],
                 "no_pos_encoding": {"xyz": (3, N), "rgb": (3, N)}}[shape]
    got, want = t_ot.make_obs_transfer(cfg, obs_shape), j_ot.make_obs_transfer(cfg, obs_shape)
    if want is None:
        assert got is None
        return
    assert {f: getattr(got, f) for f in got.__dataclass_fields__} == \
        {f: getattr(want, f) for f in want.__dataclass_fields__}


def test_bad_obs_transfer_keys_raise():
    with pytest.raises(ValueError, match="pack_mode"):
        t_ot.make_obs_transfer(dict(pack_mode="wire"), _env_params()["obs_shape"])
    with pytest.raises(ValueError, match="unknown obs_transfer_cfg keys"):
        t_ot.make_obs_transfer(dict(pos_on_device=True), _env_params()["obs_shape"])


@pytest.mark.parametrize("seg", [False, True], ids=["xyz_rgb", "with_seg"])
@pytest.mark.parametrize("pack_dtype", [None, "float16"])
def test_pack_and_complete_packed_match_jax(seg, pack_dtype):
    obs = _obs(4, seed=1, seg=seg)
    obs["state"] = np.random.RandomState(2).randn(4, 7).astype(np.float32)
    spec_cfg = dict(pos_encoding_on_device=True, pack_dtype=pack_dtype)
    obs_shape = _env_params(seg=seg)["obs_shape"]
    t_spec, j_spec = t_ot.make_obs_transfer(spec_cfg, obs_shape), j_ot.make_obs_transfer(spec_cfg, obs_shape)
    for ts, js in ((None, None), (t_spec, j_spec)):
        (tp, tstate), (jp, jstate) = t_pack(obs, spec=ts), j_pack(obs, spec=js)
        assert tp.dtype == jp.dtype and tp.shape == jp.shape
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tstate, jstate)
    small, _ = t_pack(obs, spec=t_spec)
    got = t_ot.complete_packed(torch.from_numpy(small), t_spec)
    want = np.asarray(j_ot.complete_packed(small, j_spec))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # a full pack passes through (only cast), in both
    full, _ = t_pack(obs)
    np.testing.assert_array_equal(t_ot.complete_packed(torch.from_numpy(full), t_spec).numpy(),
                                  np.asarray(j_ot.complete_packed(full, j_spec)))
    with pytest.raises(ValueError, match="channels"):
        t_ot.complete_packed(torch.from_numpy(full[:, :-1]), t_spec)


def test_complete_obs_dict_matches_jax():
    spec_cfg = dict(pos_encoding_on_device=True)
    t_spec = t_ot.make_obs_transfer(spec_cfg, _env_params()["obs_shape"])
    j_spec = j_ot.make_obs_transfer(spec_cfg, _env_params()["obs_shape"])
    obs = {k: v for k, v in _obs(3).items() if k != "pos_encoding"}
    # batched [B, ...] and windowed [B, T, ...] leaves
    for leaves in (obs, {k: np.stack([v, v]) for k, v in obs.items()}):
        got = t_ot.complete_obs_dict({k: torch.from_numpy(v) for k, v in leaves.items()}, t_spec)
        want = j_ot.complete_obs_dict(leaves, j_spec)
        assert sorted(got) == sorted(want)
        np.testing.assert_array_equal(got["pos_encoding"].numpy(), np.asarray(want["pos_encoding"]))
    full = {k: torch.from_numpy(v) for k, v in _obs(3).items()}
    assert t_ot.complete_obs_dict(full, t_spec) is full
    packed = {"pcd": torch.zeros(3, N, 9)}
    assert t_ot.complete_obs_dict(packed, t_spec) is packed


# ------------------------------------------------------------------- act
ACT_CASES = {
    "pos_on_device": (dict(pos_encoding_on_device=True), 0.0),
    "f16": (dict(pos_encoding_on_device=True, pack_dtype="float16"), F16_ATOL),
    "dict": (dict(pos_encoding_on_device=True, pack_mode="dict"), 1e-6),
    "dict_f16": (dict(pos_encoding_on_device=True, pack_mode="dict", pack_dtype="float16"), F16_ATOL),
    "f16_keep_pos": (dict(pos_encoding_on_device=False, pack_dtype="float16"), F16_ATOL),
}


@pytest.mark.parametrize("case", sorted(ACT_CASES))
def test_act_with_transfer_gives_the_full_obs_actions(case):
    cfg, atol = ACT_CASES[case]
    base = t_build_agent(dict(_walker_cfg(cfg=None), device="cpu"))
    opt = t_build_agent(dict(_walker_cfg(cfg=cfg), device="cpu"))
    assert opt.obs_transfer is not None
    obs = _obs(5, seed=3)
    for mode in ("eval", "explore"):
        np.testing.assert_allclose(opt.forward(obs, mode=mode), base.forward(obs, mode=mode), rtol=0, atol=atol)


def test_act_upload_is_what_the_spec_asks():
    agent = t_build_agent(dict(_walker_cfg(cfg=dict(pos_encoding_on_device=True, pack_dtype="float16")),
                               device="cpu"))
    seen = []
    act = agent.act
    agent.act = lambda o, mode: (seen.append(o), act(o, mode))[1]
    agent.forward(_obs(2), mode="eval")
    x = seen[0]
    assert isinstance(x, torch.Tensor) and x.dtype == torch.float32 and x.shape == (2, 9, N)
    np.testing.assert_array_equal(x[:, 6:9].numpy(), _obs(2)["pos_encoding"].astype(np.float32))
    d = t_build_agent(dict(_walker_cfg(cfg=dict(pos_encoding_on_device=True, pack_mode="dict",
                                                 pack_dtype="float16")), device="cpu"))
    up = d._upload_obs
    uploads = []
    d._device_obs = lambda o: (uploads.append(o), o)[1]
    up(_obs(2))
    assert set(uploads[0]) == {"xyz", "rgb"}
    assert uploads[0]["xyz"].dtype == torch.float16 and uploads[0]["rgb"].dtype == torch.uint8


@pytest.mark.parametrize("case", ["pos_on_device", "f16", "dict"])
def test_act_with_transfer_matches_jax(case):
    cfg, atol = ACT_CASES[case]
    agent_cfg = _walker_cfg(cfg=cfg)
    j_agent = j_build_agent(agent_cfg)
    t_agent = t_build_agent(dict(agent_cfg, device="cpu"))
    st = j_agent.train_state
    t_agent.load_params(params_from_jax(st.params, st.target_params, st.log_alpha))
    obs = _obs(6, seed=4)
    np.testing.assert_allclose(t_agent.forward(obs, mode="eval"), j_agent.forward(obs, mode="eval"), **FWD_TOL)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_walker_full_width_params_carry_across(bf16):
    """``params_from_jax`` at the recipe's own widths (PointNet [64, 128,
    256] -> 50 with ``ignore_first_ln``, heads 1024 x 1024, 3 x 512 points
    of 9 channels): every parameter maps, and the act agrees.  bf16: both
    round at the same points, a sum in another order may flip one bf16
    step (tests/test_torch_bf16.py): 1e-2 relative, 1e-3 absolute."""
    from pointcloud_rl_torch.models import get_kwargs_from_shape, replace_placeholder_with_args

    cfg = Config.fromfile(WALKER_CONFIG)
    cfg.merge_from_dict({"agent_cfg.bf16": bf16})
    n = 3 * 512
    env_params = dict(obs_shape={"xyz": (3, n), "rgb": (3, n), "pos_encoding": (3, n)}, action_shape=A,
                      is_discrete=False, action_space=_Box(-1.0, 1.0, (A,)))
    agent_cfg = dict(replace_placeholder_with_args(dict(cfg["agent_cfg"]),
                                                   **get_kwargs_from_shape(env_params["obs_shape"], A)))
    agent_cfg = dict(agent_cfg, env_params=env_params, seed=0)
    j_agent = j_build_agent(agent_cfg)
    t_agent = t_build_agent(dict(agent_cfg, device="cpu"))
    st = j_agent.train_state
    t_agent.load_params(params_from_jax(st.params, st.target_params, st.log_alpha))
    assert t_agent.model.visual.final_dense.weight.shape == (50, 256)
    rs = np.random.RandomState(6)
    obs = {"xyz": rs.randn(2, 3, n).astype(np.float32), "rgb": rs.randint(0, 256, (2, 3, n)).astype(np.uint8),
           "pos_encoding": np.broadcast_to(np.repeat(np.eye(3, dtype=np.uint8), 512, -1), (2, 3, n)).copy()}
    tol = dict(rtol=1e-2, atol=1e-3) if bf16 else FWD_TOL
    np.testing.assert_allclose(t_agent.forward(obs, mode="eval"), j_agent.forward(obs, mode="eval"), **tol)


# ---------------------------------------------------------------- update
def _transitions(n, seed=0):
    rs = np.random.RandomState(seed)
    return dict(obs=_obs(n, seed), next_obs=_obs(n, seed + 1),
                actions=np.clip(rs.randn(n, A), -0.99, 0.99).astype(np.float32),
                rewards=rs.randn(n, 1).astype(np.float32), dones=rs.rand(n, 1) < 0.2,
                episode_dones=np.zeros((n, 1), bool))


def test_walker_width_update_without_the_block_matches_jax(monkeypatch):
    """Both agents from one parameter set; the port samples a
    ``DeviceReplayMemory`` that stores no pos_encoding, JAX gets the same
    rows without it; both complete the obs before the update.  Two updates:
    the first steps the actor (interval 2), both the critic."""
    _pin_noise(monkeypatch)
    agent_cfg = _walker_cfg(cfg=dict(pos_encoding_on_device=True, pack_dtype="float16"))
    j_agent = j_build_agent(agent_cfg)
    t_agent = t_build_agent(dict(agent_cfg, device="cpu"))
    st = j_agent.train_state
    t_agent.load_params(params_from_jax(st.params, st.target_params, st.log_alpha))

    trans = _transitions(40)
    mem = DeviceReplayMemory(capacity=64, seed=0, device="cpu", transfer_cfg=dict(drop_subkeys=("pos_encoding",)),
                             keys=["obs", "next_obs", "actions", "rewards", "dones", "episode_dones"])
    mem.push_batch(trans)
    assert "pos_encoding" not in mem.storage["obs"] and "pos_encoding" not in mem.storage["next_obs"]
    idx = np.random.RandomState(5).randint(0, 40, 16)
    t_batch = mem.gather(torch.as_tensor(idx))

    def rows(tree):
        return {k: rows(v) for k, v in tree.items() if k != "pos_encoding"} if isinstance(tree, dict) else tree[idx]

    j_batch = rows({k: trans[k] for k in ("obs", "next_obs", "actions", "rewards", "dones", "episode_dones")})
    for u in range(2):
        jm = j_agent.update_parameters(_FixedMemory(j_batch), updates=u)
        tm = t_agent.update_parameters(_FixedMemory(t_batch), updates=u)
        keys = ["critic_loss", "q", "q_target", "alpha"] + (["actor_loss", "entropy"] if u == 0 else [])
        for key in keys:
            a, b = jm[f"sac/{key}"], tm[f"sac/{key}"]
            assert abs(a - b) < METRIC_RTOL * (1 + abs(a)), f"update {u} {key}: jax {a} vs torch {b}"
    # every parameter inside Adam's sign-flip envelope, >90% of each tensor tight
    envelope = 2 * LR * 2 * 1.01
    params = jax.device_get(j_agent.train_state.params)
    for name, value in t_agent.model.state_dict().items():
        diff = np.abs(value.numpy() - jax_leaf(params, name))
        assert diff.max() < envelope, f"{name}: max diff {diff.max()}"
        assert (diff < 1e-4).mean() > 0.9, f"{name}: only {(diff < 1e-4).mean():.2%} tight"


def test_update_completes_the_obs_before_augmenting():
    """With a pre_process augmentation, the block is back in place (channel
    order xyz, rgb, pos_encoding) when the augmentation sees the obs."""
    agent = t_build_agent(dict(_walker_cfg(cfg=dict(pos_encoding_on_device=True)), device="cpu"))
    seen = []
    agent.obs_processor = lambda g, obs: (seen.append(obs), obs)[1]
    trans = _transitions(16)
    batch = {k: v for k, v in trans.items()}
    for key in ("obs", "next_obs"):
        batch[key] = {k: v for k, v in trans[key].items() if k != "pos_encoding"}
    agent.update_parameters(_FixedMemory(batch), updates=0)
    assert len(seen) == 2
    for obs in seen:
        assert list(obs) == ["xyz", "rgb", "pos_encoding"]
        np.testing.assert_array_equal(obs["pos_encoding"][0].numpy(), trans["obs"]["pos_encoding"][0])
