"""The port's DM Control path against the JAX package's.

``env/dmc.py`` is a numpy copy: from the same dm_control seed and actions,
the port's env gives the JAX env's observations bit for bit, on the native
sampler and on the numpy path, in the pointcloud (with ground/body budget,
and ``num_ground=-1`` with ``filter_seg``), rgbd and raw modes.  The
builder dispatches ``dmc_*`` names with the same per-domain defaults.
``ServerObsVectorEnv`` fuses raw renders into the host pipeline's
contract on an explicit device, and refuses a device it does not have.

The dm_control tests are guarded as ``tests/test_dmc.py`` guards them
(rendering is headless EGL, ``MUJOCO_GL=egl``); tolerances: none, every
comparison is exact, except where a fused point is matched to the host's
unprojected pixel (1e-5: the fusion unprojects in f32, the host in f64).
"""

import os
import os.path as osp
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from pointcloud_rl_torch.env import build_vec_env as t_build_vec_env
from pointcloud_rl_torch.env.server_env import ServerObsVectorEnv
from pointcloud_rl_torch.ops.obs_fuse import dmc_raw_to_pointcloud

torch.set_num_threads(1)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))

pytestmark = pytest.mark.dmc


def _dmc_available():
    try:
        from dm_control import suite  # noqa: F401

        return True
    except Exception:
        return False


requires_dmc = pytest.mark.skipif(not _dmc_available(), reason="dm_control unavailable")


@requires_dmc
def test_dmc_names_and_tables_match_jax():
    from pointcloud_rl_torch.env import dmc as t_dmc
    from pointcloud_rl_tpu.env import dmc as j_dmc

    for name in ("dmc_cheetah_run-v0", "dmc_ball_in_cup_catch-v0", "dmc_walker_walk-v0",
                 "distract_dmc_quadruped_walk-v0", "dmc_finger_turn_hard-v0"):
        assert t_dmc.parse_dmc_name(name) == j_dmc.parse_dmc_name(name)
    assert t_dmc.parse_dmc_name("dmc_walker_walk-v0") == ("walker", "walk")
    with pytest.raises(KeyError):
        t_dmc.parse_dmc_name("dmc_nodomain_run-v0")
    for table in ("DEFAULT_ACTION_REPEAT", "DEFAULT_DEPTH_FILTER", "DEFAULT_GROUND_EPS"):
        t, j = getattr(t_dmc, table), getattr(j_dmc, table)
        assert dict(t) == dict(j) and t["no_such_domain"] == j["no_such_domain"], table
    assert t_dmc.DEFAULT_NUM_BODY == j_dmc.DEFAULT_NUM_BODY


@requires_dmc
@pytest.mark.parametrize("name, kwargs", [
    ("dmc_walker_walk-v0", {}),
    ("dmc_cartpole_swingup-v0", dict(num_ground=50)),
    ("dmc_quadruped_walk-v0", dict(n_points=300, episode_length=500, frame_skip=3)),
], ids=["walker", "cartpole_num_ground", "quadruped_overrides"])
def test_build_dmc_env_defaults_match_jax(name, kwargs):
    from pointcloud_rl_torch.env.dmc import build_dmc_env as t_build
    from pointcloud_rl_tpu.env.dmc import build_dmc_env as j_build

    t, j = t_build(name, obs_mode="pointcloud", **kwargs), j_build(name, obs_mode="pointcloud", **kwargs)
    try:
        assert t._max_episode_steps == j._max_episode_steps
        for attr in ("domain", "task_name", "frame_skip", "max_depth", "n_points", "num_ground", "ground_eps",
                     "camera_id", "z_to_world", "fix_base_z", "use_native", "fast_render"):
            assert getattr(t.env, attr) == getattr(j.env, attr), attr
        np.testing.assert_array_equal(t.env.inv_intrinsic, j.env.inv_intrinsic)
        if name == "dmc_walker_walk-v0":  # the walker recipe's per-frame cloud
            assert (t.env.n_points, t.env.num_ground, t.env.ground_eps, t.env.frame_skip) == (512, 128, 8e-3, 2)
            assert t._max_episode_steps == 500
    finally:
        t.close()
        j.close()


# (obs_mode, env overrides, native sampler): each mode the DMC env has.
OBS_CASES = {
    "pointcloud_native": ("pointcloud", {}, True),
    "pointcloud_numpy": ("pointcloud", {}, False),
    "filter_seg": ("pointcloud", dict(num_ground=-1, n_points=200), True),
    "rgbd": ("rgbd", {}, True),
    "raw": ("raw", {}, True),
}


# Renders happen in a process of their own: a process that has rendered with
# EGL must not fork renderers afterwards, and a pytest-xdist worker (no
# __main__ file) forks its env workers.  The script builds each case's env in
# both packages, seeds them alike, resets and takes two steps with the same
# actions, and pickles what each side returned; it also keeps the raw
# renders of a stacked cartpole for the server-env tests below.
_RENDER = textwrap.dedent("""
    import pickle, sys
    import numpy as np
    from pointcloud_rl_torch.env import build_env as t_build_env
    from pointcloud_rl_tpu.env import build_env as j_build_env

    def unwrap(env):
        while type(env).__name__ != "DMCEnv":
            env = env.env
        return env

    cases, out = eval(sys.argv[1]), {}
    for name, (cfg, native, seed, steps) in cases.items():
        sides = []
        for build in (t_build_env, j_build_env):
            env = build(cfg)
            unwrap(env).use_native = native and unwrap(env).use_native
            env.seed(seed)
            rs = np.random.RandomState(0)
            got = [(env.reset(), None, None)]
            for _ in range(steps):
                o, r, d, _ = env.step(rs.uniform(-1, 1, env.action_space.shape).astype(np.float32))
                got.append((o, r, d))
            sides.append({"native": unwrap(env).use_native, "steps": got,
                          "inv_k": np.asarray(unwrap(env).inv_intrinsic)})
            env.close()
        out[name] = sides
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
""")

SERVER_CFG = dict(type="gym", env_name="dmc_cartpole_swingup-v0", obs_mode="pointcloud", stack_frame=3,
                  server_obs=True, image_size=(48, 48), n_points=128, num_ground=32)
_RAW_CFG = dict({k: v for k, v in SERVER_CFG.items() if k != "server_obs"}, obs_mode="raw")


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    cases = {name: (dict(type="gym", env_name="dmc_cartpole_swingup-v0", obs_mode=mode, image_size=(48, 48),
                         stack_frame=1 if mode == "raw" else 3, **extra), native, 0, 2)
             for name, (mode, extra, native) in OBS_CASES.items()}
    cases["walker"] = (dict(type="gym", env_name="dmc_walker_walk-v0", obs_mode="pointcloud", stack_frame=3),
                       True, 3, 0)
    cases["stacked_raw"] = (_RAW_CFG, True, 0, 0)
    path = tmp_path_factory.mktemp("renders") / "renders.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu", MUJOCO_GL="egl", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _RENDER, repr(cases), str(path)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _same_steps(port, jax_side):
    assert len(port) == len(jax_side)
    for (a, ra, da), (b, rb, db) in zip(port, jax_side):
        assert (ra, da) == (rb, db)
        assert sorted(a) == sorted(b)
        for key in b:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@requires_dmc
@pytest.mark.parametrize("case", sorted(OBS_CASES))
def test_dmc_obs_match_jax(case, renders):
    port, jax_side = renders[case]
    assert port["native"] == jax_side["native"] == OBS_CASES[case][2]
    _same_steps(port["steps"], jax_side["steps"])
    if case == "filter_seg":
        assert port["steps"][0][0]["filter_seg"].shape == (1, 600)


@requires_dmc
def test_walker_pointcloud_obs_match_jax(renders):
    """The walker recipe's env at its full size: 3 x 512 points of 84 x 84 renders."""
    port, jax_side = renders["walker"]
    obs = port["steps"][0][0]
    assert obs["xyz"].shape == (3, 1536) and obs["pos_encoding"].shape == (3, 1536)
    _same_steps(port["steps"], jax_side["steps"])


# ------------------------------------------------------------ server env


@requires_dmc
def test_server_vec_env_contract(monkeypatch):
    """server_obs=True: raw-mode workers, one fusion on the device per batch,
    and the host pipeline's observation contract (tests/test_server_env.py)."""
    host_cfg = {k: v for k, v in SERVER_CFG.items() if k != "server_obs"}
    # every renderer in a worker process, started by spawn (a pytest-xdist
    # worker would fork, and this process may have rendered with EGL before)
    monkeypatch.setenv("PCRL_MP_START", "spawn")
    env = t_build_vec_env(SERVER_CFG, num_procs=2, base_seed=0, device="cpu")
    host = t_build_vec_env(host_cfg, num_procs=1, base_seed=0, vec_backend="subprocess", device="cpu")
    try:
        assert isinstance(env.vec_env, ServerObsVectorEnv) and env.vec_env.device.type == "cpu"
        obs, ref = env.reset(), host.reset()
        assert sorted(obs) == sorted(ref) == ["pos_encoding", "rgb", "xyz"]
        for key in obs:
            assert obs[key].shape == (2,) + ref[key].shape[1:] and obs[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(obs["pos_encoding"][0], ref["pos_encoding"][0])
        assert abs(float(np.abs(obs["xyz"]).max()) - float(np.abs(ref["xyz"]).max())) < 1.0
        actions = np.stack([env.single_action_space.sample() for _ in range(2)])
        obs2, rewards, dones, _ = env.step(actions)
        assert obs2["xyz"].shape == (2, 3, 3 * 128) and rewards.shape == (2, 1) and dones.shape == (2, 1)
        # the unified API writes next_obs into its cached buffer in place
        ret = env.step_dict(actions)
        assert ret["obs"]["xyz"].shape == (2, 3, 3 * 128)
        assert np.isfinite(env.step_dict(actions)["rewards"]).all()
        batch = env.step_random_actions(4)
        assert batch["obs"]["xyz"].shape == (4, 3, 3 * 128) and batch["next_obs"]["rgb"].dtype == np.uint8
    finally:
        env.close()
        host.close()


class _RawInner:
    """An inner vec env that returns recorded raw renders (``obs_mode="raw"``,
    stacked) and the env attributes the server env reads."""

    def __init__(self, raw, attrs):
        self.raw, self.attrs = raw, attrs
        self.num_envs = len(raw["depth"])

    def get_attr(self, name, idx=None):
        return self.attrs[name]

    def reset(self, idx=None, **kwargs):
        return {k: v.copy() for k, v in self.raw.items()}


@requires_dmc
def test_server_fusion_is_the_ops_fusion_of_the_raw_renders(renders):
    """The server env's fused obs are ``dmc_raw_to_pointcloud`` of the inner
    env's raw renders with a generator of the server's seed; every fused
    point is a pixel of the host pipeline's unprojection of the same render."""
    port, _ = renders["stacked_raw"]
    raw = {k: v[None] for k, v in port["steps"][0][0].items()}  # one env
    attrs = dict(n_points=128, num_ground=32, ground_eps=0.01, max_depth=5.0, z_to_world=True, fix_base_z=None,
                 inv_intrinsic=port["inv_k"])  # cartpole's ground_eps and depth filter
    server = ServerObsVectorEnv(_RawInner(raw, attrs), num_frames=3, seed=7, device="cpu")
    got = server.reset()
    want = dmc_raw_to_pointcloud(*(torch.from_numpy(raw[k]) for k in ("depth", "rgb", "cam")), server._inv_k,
                                 generator=torch.Generator().manual_seed(7), **server._fuse_kw)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key].numpy(), err_msg=key)
    # the host pipeline's unprojection of the newest frame (DMCEnv._unproject, camera row)
    depth = raw["depth"][0, -1].astype(np.float64)
    v, u = np.indices(depth.shape)
    uv1 = np.stack([u + 0.5, v + 0.5, np.ones_like(depth)], axis=-1)
    cm = raw["cam"][0, -1, 0]
    host = ((uv1 @ port["inv_k"].T * depth[..., None]) @ cm[:9].reshape(3, 3).astype(np.float64).T).reshape(-1, 3)
    host[:, 2] += cm[9]
    valid = depth.reshape(-1) <= 5.0
    pts = got["xyz"][0, :, 2 * 128:].T
    assert np.abs(pts[:, None, :] - host[valid][None]).max(-1).min(-1).max() < 1e-5


class _FakeRawInner:
    """An inner vec env of raw renders (no simulator): 2 envs, 2 frames."""

    num_envs = 2
    attrs = dict(n_points=16, num_ground=4, ground_eps=0.05, max_depth=5.0, z_to_world=True, fix_base_z=None,
                 inv_intrinsic=np.linalg.inv(np.array([[10.0, 0, 3.5], [0, 10.0, 3.5], [0, 0, 1.0]])))

    def get_attr(self, name, idx=None):
        return self.attrs[name]

    def reset(self, idx=None, **kwargs):
        rs = np.random.RandomState(0)
        cam = np.zeros((2, 2, 1, 12), np.float32)
        cam[..., :9] = np.eye(3, dtype=np.float32).reshape(-1)
        return {"depth": rs.uniform(0.5, 2.0, (2, 2, 8, 8)).astype(np.float32),
                "rgb": rs.randint(0, 256, (2, 6, 8, 8)).astype(np.uint8), "cam": cam}


def test_server_env_on_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the refusal is what a machine without one must do")
    with pytest.raises(RuntimeError, match="cuda"):
        ServerObsVectorEnv(_FakeRawInner(), num_frames=2, device="cuda")


@pytest.mark.parametrize("frames", [1, 2])
def test_server_env_contract_without_a_simulator(frames):
    server = ServerObsVectorEnv(_FakeRawInner(), num_frames=frames, seed=3, device="cpu")
    obs = server.reset()
    assert set(obs) == ({"xyz", "rgb", "pos_encoding"} if frames > 1 else {"xyz", "rgb"})
    assert obs["xyz"].shape == (2, 3, 32) and obs["xyz"].dtype == np.float32 and obs["rgb"].dtype == np.uint8
    assert isinstance(obs["xyz"], np.ndarray) and obs["xyz"].flags.writeable
    again = ServerObsVectorEnv(_FakeRawInner(), num_frames=frames, seed=3, device="cpu").reset()
    np.testing.assert_array_equal(obs["xyz"], again["xyz"])  # the seed fixes the draws


def test_builder_dispatch_names_the_roadmap_items():
    from pointcloud_rl_torch.env.builder import _build_base_env

    # A8 is ported: without the A2 robot's assets a MuJoCo task raises the JAX package's own error
    with pytest.raises(AssertionError, match="A2 robot assets/configs not found"):
        _build_base_env("OpenCabinetDrawerMJC_train-v0", "pointcloud")
    # A9 is ported: any other name goes to the gymnasium registry, as in the JAX package
    from pointcloud_rl_torch.env.gym_adapter import GymnasiumAdapter

    assert isinstance(_build_base_env("Pendulum-v1", "state"), GymnasiumAdapter)
    with pytest.raises(KeyError, match="Unknown env"):
        _build_base_env("NoSuchEnv-v0", "state")


def test_server_obs_needs_the_pointcloud_mode():
    from pointcloud_rl_torch.env.vec_env import build_vec_env_from_cfgs

    with pytest.raises(ValueError, match="pointcloud"):
        build_vec_env_from_cfgs([dict(type="gym", env_name="dmc_walker_walk-v0", obs_mode="rgb", server_obs=True)],
                                device="cpu")
