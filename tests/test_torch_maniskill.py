"""The port's ManiSkill path against the JAX package's, on the CPU.

The adapter (``env/maniskill.py``) runs under the mock SAPIEN stack of
``tests/test_maniskill_adapter.py`` (fake ``sapien`` / ``mani_skill.env`` /
classic ``gym`` modules): for the same raw observations and the same
global numpy seed its output equals the JAX adapter's bitwise (point
cloud, ``target_info``, the image modes' CHW, the state passthrough).  The
builder routes the ManiSkill names to it and refuses the ``*MJC*`` names
(ROADMAP A8).  One SAC update of ``sac/maniskill/pn.py`` and one DrQ
update of ``drq/maniskill/pn_shift.py`` at narrow widths, from the same
converted parameters on the same batch with the draws injected, agree
with the JAX package's.  Then ``run_rl`` trains both configs, tiny, with
two env worker processes over ``chip_smoke.py``'s stand-in simulator.
"""

import json
import os
import os.path as osp
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, osp.dirname(__file__))

from test_maniskill_adapter import _FakeManiSkillEnv  # noqa: E402
from test_torch_drq import _assert_params_match, _run_updates  # noqa: E402
from test_torch_models import FWD_TOL  # noqa: E402
from test_torch_sac import METRIC_RTOL, N_UPDATES, _FixedMemory, _pin_noise  # noqa: E402

from pointcloud_rl_torch.convert import params_from_jax  # noqa: E402
from pointcloud_rl_torch.env import maniskill as t_ms  # noqa: E402
from pointcloud_rl_torch.ops import augment as ta  # noqa: E402
from pointcloud_rl_tpu.env import maniskill as j_ms  # noqa: E402
from pointcloud_rl_tpu.ops import augment as ja  # noqa: E402

torch.set_num_threads(1)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
SAC_CONFIG = "configs/mfrl/sac/maniskill/pn.py"
DRQ_CONFIG = "configs/mfrl/drq/maniskill/pn_shift.py"
B, N_POINTS, ACTIONS = 16, 64, 22
# The configs at test size: PointNet [16, 16, 32] -> 16 on the 9 channels
# (xyz, rgb, 3 seg masks), heads 32 wide on 16 + 38 state, batch 16.
NARROW = {
    "agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.mlp_spec": [16, 16, 32],
    "agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.out_channels": 16,
    "agent_cfg.actor_cfg.nn_cfg.mlp_cfg.mlp_spec": ["16 + agent_shape", 32, 32, "action_shape * 2"],
    "agent_cfg.critic_cfg.nn_cfg.mlp_cfg.mlp_spec": ["16 + agent_shape + action_shape", 32, 32, 1],
    "agent_cfg.batch_size": B,
}
FUSED = "agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.fused"


class _ImageFakeEnv(_FakeManiSkillEnv):
    """The mock env with the image observation modes: ``{mode: {"rgb" HWC
    float in [0, 1], "depth" HWC}, "agent": state}``."""

    def _obs(self):
        if self.obs_mode not in ("rgb", "rgbd", "depth"):
            return super()._obs()
        images = {"rgb": self.rng.uniform(0, 1, (8, 10, 3)).astype(np.float32),
                  "depth": self.rng.uniform(0, 2, (8, 10, 1)).astype(np.float32)}
        obs = {self.obs_mode: images, "agent": np.arange(38, dtype=np.float32)}
        if self.with_target_info:
            obs["target_info"] = np.array([0.5, -1.0], np.float32)
        return obs


def _install_stack(monkeypatch, env_cls=_FakeManiSkillEnv):
    made = []
    fake_gym = types.ModuleType("gym")

    def make(env_name, **kwargs):
        made.append((env_name, dict(kwargs)))
        return env_cls(**kwargs.pop("fake_kwargs", {}))

    fake_gym.make = make
    fake_mani = types.ModuleType("mani_skill")
    fake_mani.env = types.ModuleType("mani_skill.env")
    monkeypatch.setitem(sys.modules, "sapien", types.ModuleType("sapien"))
    monkeypatch.setitem(sys.modules, "mani_skill", fake_mani)
    monkeypatch.setitem(sys.modules, "mani_skill.env", fake_mani.env)
    monkeypatch.setitem(sys.modules, "gym", fake_gym)
    return made


def assert_bitwise(a, b):
    if isinstance(b, dict):
        assert list(a) == list(b)
        for k in b:
            assert_bitwise(a[k], b[k])
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


ADAPTER_CASES = {
    "pointcloud": ("pointcloud", dict(n_points=640), {}),
    "pointcloud_target_info": ("pointcloud", {}, dict(with_target_info=True)),
    "pointcloud_few_raw_points": ("pointcloud", dict(n_points=1200), dict(n_raw=1000)),
    "rgb": ("rgb", {}, {}),
    "rgbd_target_info": ("rgbd", {}, dict(with_target_info=True)),
    "state": ("state", {}, {}),
}


@pytest.mark.parametrize("case", sorted(ADAPTER_CASES))
def test_adapter_matches_jax_bitwise(case, monkeypatch):
    obs_mode, build_kw, fake_kw = ADAPTER_CASES[case]
    _install_stack(monkeypatch, _ImageFakeEnv)
    out = {}
    for tag, m in (("torch", t_ms), ("jax", j_ms)):
        env = m.build_maniskill_env("OpenCabinetDoor-v0", obs_mode=obs_mode, fake_kwargs=dict(fake_kw), **build_kw)
        seq = []
        for t in range(4):
            np.random.seed(100 + t)  # pcd_base draws from the global numpy state
            seq.append(env.reset(level=t) if t == 0 else env.step(np.zeros(13, np.float32))[0])
        out[tag] = seq
    for got, want in zip(out["torch"], out["jax"]):
        assert_bitwise(got, want)
    first = out["torch"][0]
    if obs_mode == "pointcloud":
        n = build_kw.get("n_points", 1200)
        assert first["xyz"].shape == (3, n) and first["rgb"].dtype == np.uint8 and first["seg"].shape == (3, n)
        assert first["state"].shape == ((40,) if fake_kw.get("with_target_info") else (38,))
    elif obs_mode == "state":
        assert isinstance(first, np.ndarray) and first.shape == (38,)
    else:
        assert first["rgb"].shape == (3, 8, 10) and first["rgb"].dtype == np.uint8
        assert first["state"].shape == ((40,) if fake_kw.get("with_target_info") else (38,))


def test_gate_raises_without_sapien():
    if "sapien" in sys.modules:
        pytest.skip("real sapien present")
    for m in (t_ms, j_ms):
        with pytest.raises(ImportError, match="sapien"):
            m.build_maniskill_env("PushChair_3001-v0")


@pytest.mark.parametrize("name", ["OpenCabinetDoor_1000-v0", "OpenCabinetDrawer_1000-v0", "PushChair_3001-v0",
                                  "MoveBucket_4000-v0"])
def test_maniskill_names_reach_the_ports_adapter(name, monkeypatch):
    from pointcloud_rl_torch.env import build_env

    made = _install_stack(monkeypatch)
    env = build_env(dict(env_name=name, obs_mode="pointcloud", n_points=320, reward_scale=0.3, ego_mode=True,
                         fake_kwargs={}))
    inner = env
    while not isinstance(inner, t_ms.ManiSkillObsWrapper):
        inner = inner.env
    assert isinstance(inner.env, _FakeManiSkillEnv) and inner.env.obs_mode == "pointcloud"
    assert made == [(name, {"ego_mode": True, "fake_kwargs": {}})]
    obs = env.reset()
    assert obs["xyz"].shape == (3, 320) and env.reward_scale == pytest.approx(0.3)


@pytest.mark.parametrize("name", ["MoveBucketMJC_train-v0", "OpenCabinetDoorMJC_train-v0",
                                  "OpenCabinetDrawerMJC_val-v0", "PushChairMJC_train-v0"])
def test_mujoco_names_raise_naming_a8(name, monkeypatch):
    from pointcloud_rl_torch.env import build_env

    _install_stack(monkeypatch)  # even with a simulator present
    with pytest.raises(NotImplementedError, match="A8"):
        build_env(dict(env_name=name, obs_mode="pointcloud"))


# ------------------------------------------------------------- the updates
def _setup(config, **agent_overrides):
    from pointcloud_rl_torch.env.spaces import Box
    from pointcloud_rl_torch.models import get_kwargs_from_shape, replace_placeholder_with_args
    from pointcloud_rl_tpu.config import Config

    cfg = Config.fromfile(osp.join(REPO, config))
    cfg.merge_from_dict(dict(NARROW, **{FUSED: True}))
    ones = np.ones(ACTIONS, np.float32)
    env_info = dict(obs_shape={"xyz": (3, N_POINTS), "rgb": (3, N_POINTS), "seg": (3, N_POINTS), "state": (38,)},
                    action_shape=ACTIONS, action_space=Box(-ones, ones), is_discrete=False)
    kwargs = get_kwargs_from_shape(env_info["obs_shape"], env_info["action_shape"])
    assert kwargs["pcd_all_channel"] == 9 and kwargs["agent_shape"] == 38
    agent_cfg = dict(replace_placeholder_with_args(dict(cfg["agent_cfg"]), **kwargs))
    agent_cfg.update(agent_overrides)
    return agent_cfg, env_info


def _obs(seed, n=B):
    """Observations as the adapter emits them: xyz f32, rgb uint8, seg bool, state f32."""
    rs = np.random.RandomState(seed)
    return {"xyz": rs.randn(n, 3, N_POINTS).astype(np.float32),
            "rgb": rs.randint(0, 256, (n, 3, N_POINTS)).astype(np.uint8),
            "seg": rs.rand(n, 3, N_POINTS) < 0.3,
            "state": rs.randn(n, 38).astype(np.float32)}


def _batch(seed=3):
    rs = np.random.RandomState(seed)
    return dict(obs=_obs(seed), next_obs=_obs(seed + 1),
                actions=np.clip(rs.randn(B, ACTIONS), -0.99, 0.99).astype(np.float32),
                rewards=rs.randn(B, 1).astype(np.float32), dones=rs.rand(B, 1) < 0.2,
                episode_dones=np.zeros((B, 1), bool))


def _agents(config):
    from pointcloud_rl_torch.algorithms import build_agent as t_build_agent
    from pointcloud_rl_tpu.algorithms import build_agent as j_build_agent

    agent_cfg, env_info = _setup(config)
    j_agent = j_build_agent(dict(agent_cfg, env_params=env_info, seed=0))
    t_agent = t_build_agent(dict(agent_cfg, env_params=env_info, seed=0, device="cpu"))
    st = j_agent.train_state
    t_agent.load_params(params_from_jax(st.params, st.target_params, st.log_alpha))
    return j_agent, t_agent


def _assert_encodes_match(j_agent, t_agent):
    """The encode, the actor's eval action and the twin Q on the same obs."""
    import jax.numpy as jnp

    obs = _obs(9, 5)
    actions = np.clip(np.random.RandomState(4).randn(5, ACTIONS), -1, 1).astype(np.float32)
    params = j_agent.train_state.params
    j_act, j_feat = j_agent.model.actor_apply(params, obs, mode="eval")
    j_q = j_agent.model.critic_apply(params, obs, actions=jnp.asarray(actions))
    t_obs = {k: torch.from_numpy(v) for k, v in obs.items()}
    with torch.no_grad():
        t_act, t_feat = t_agent.model.actor_apply(t_obs, mode="eval")
        t_q = t_agent.model.critic_apply(t_obs, actions=torch.from_numpy(actions))
    assert tuple(t_feat.shape) == (5, 16) and tuple(t_q.shape) == (5, 2)
    for got, want in ((t_feat, j_feat), (t_act, j_act), (t_q, j_q)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_sac_update_of_the_maniskill_config_matches_jax(monkeypatch):
    _pin_noise(monkeypatch)
    j_agent, t_agent = _agents(SAC_CONFIG)
    _assert_encodes_match(j_agent, t_agent)
    batch = _batch()
    _run_updates(j_agent, t_agent, _FixedMemory(batch), _FixedMemory(batch), N_UPDATES, "sac", METRIC_RTOL)
    _assert_params_match(j_agent, t_agent, N_UPDATES)


def test_drq_update_of_the_maniskill_shift_config_matches_jax(monkeypatch):
    """pn_shift.py: DrQ with num_aug=2 and a GlobalRotScaleTrans shift of
    up to 0.1 on every axis, the height too (``shift_height``); the shift
    drawn for the n-th call of an update is the same on both sides."""
    import jax.numpy as jnp

    _pin_noise(monkeypatch)
    calls_per_update = 2
    counts = {"jax": 0, "torch": 0}

    def shift(rows, i):
        return np.random.RandomState(31 + i).uniform(-0.1, 0.1, (rows, 3)).astype(np.float32)

    def pinned(side, convert):
        def sample_info(self, generator, main_data):
            assert self.rot_range is None and self.scale_ratio_range is None and self.shift_height
            i = counts[side] % calls_per_update
            counts[side] += 1
            return None, convert(shift(main_data.shape[0], i))
        return sample_info

    monkeypatch.setattr(ja.GlobalRotScaleTrans, "sample_info", pinned("jax", jnp.asarray))
    monkeypatch.setattr(ta.GlobalRotScaleTrans, "sample_info", pinned("torch", torch.from_numpy))
    j_agent, t_agent = _agents(DRQ_CONFIG)
    assert t_agent.num_aug == 2 and t_agent.metric_prefix == "drq"
    _assert_encodes_match(j_agent, t_agent)
    batch = _batch()
    _run_updates(j_agent, t_agent, _FixedMemory(batch), _FixedMemory(batch), N_UPDATES, "drq", METRIC_RTOL)
    assert counts["torch"] == N_UPDATES * calls_per_update
    _assert_params_match(j_agent, t_agent, N_UPDATES)


# --------------------------------------------------------- run_rl, tiny
TINY_CLI = [f"{k}={v}" for k, v in NARROW.items()]


@pytest.mark.parametrize("config", [SAC_CONFIG, DRQ_CONFIG], ids=["sac_pn", "drq_pn_shift"])
def test_run_rl_trains_over_the_stand_in_simulator(config, tmp_path):
    """``run_rl`` in a process of its own with the stand-in ``sapien``,
    ``mani_skill.env`` and ``gym`` on ``PYTHONPATH`` (its two env workers
    start from a forkserver, which must import them too)."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    root = chip_smoke.write_maniskill_standin(str(tmp_path / "standin"))
    log = tmp_path / "made.jsonl"
    env = chip_smoke.standin_env(root, str(log))
    env["OMP_NUM_THREADS"] = "1"
    wd = tmp_path / "wd"
    cmd = [sys.executable, "-m", "pointcloud_rl_torch.apis.run_rl", config, "--work-dir", str(wd), "--seed", "0",
           "--device", "cpu", "--cfg-options", *TINY_CLI, f"{FUSED}=True", "env_cfg.n_points=64",
           "replay_cfg.capacity=500", "train_cfg.total_steps=64", "train_cfg.warm_steps=32", "train_cfg.n_log=16",
           "train_cfg.exp_logger_cfg.type=csv", "rollout_cfg.num_procs=2", "eval_cfg.save_video=False"]
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    summary = json.loads((wd / "0" / "run_summary.json").read_text())
    assert summary["pointcloud_rl_tpu_modules"] == [] and summary["jax_modules"] == []
    assert summary["steps"] == 64 and summary["grad_steps"] == 8
    prefix = "drq" if config == DRQ_CONFIG else "sac"
    assert f"{prefix}/critic_loss" in (wd / "0" / "logs" / "metrics.csv").read_text().splitlines()[0]
    made = [json.loads(line) for line in log.read_text().splitlines()]
    # the run's env info, its evaluator and its two env workers: all by the port's adapter
    assert {m["caller"] for m in made} == {"pointcloud_rl_torch.env.maniskill"}
    assert len({m["pid"] for m in made}) == 3 and len(made) == 4
    assert "Env info: obs={'xyz': (3, 64), 'rgb': (3, 64), 'seg': (3, 64), 'state': (38,)}" in out.stderr
