"""The port's last host modules against the JAX package's.

``env/gym_adapter.py``, ``version.py`` and ``utils/visualization.py`` are
copies, held to their originals on the same inputs; the env builder's
fallback to the gymnasium registry; ``utils/flops.py`` counts with
``torch.utils.flop_counter`` what the JAX package asks XLA for: the same
parameter counts, and for products the same FLOP (XLA also counts
elementwise ops, which ``FlopCounterMode`` does not).
"""

import csv
import os.path as osp
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, osp.dirname(__file__))

from test_torch_models import TINY, slice_obs, slice_setup  # noqa: E402

torch.set_num_threads(1)

STEPS = 210  # past Pendulum's 200-step time limit


def _drive(env, seed):
    """Seeded actions through ``env``: every step's obs, reward, done and
    ``TimeLimit.truncated``, with a reset after the episode ends."""
    rs = np.random.RandomState(seed)
    env.seed(seed)
    out = [env.reset()]
    for _ in range(STEPS):
        obs, reward, done, info = env.step(rs.uniform(-2, 2, size=(1,)).astype(np.float32))
        out.append((obs, reward, done, info.get("TimeLimit.truncated", False)))
        if done:
            out.append(env.reset())
    return out


def _assert_same_steps(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(b, tuple):
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1:] == b[1:]
        else:
            np.testing.assert_array_equal(a, b)


def test_gymnasium_adapter_matches_the_original():
    import gymnasium

    from pointcloud_rl_torch.env.gym_adapter import GymnasiumAdapter as T
    from pointcloud_rl_tpu.env.gym_adapter import GymnasiumAdapter as J

    got, want = _drive(T(gymnasium.make("Pendulum-v1")), 3), _drive(J(gymnasium.make("Pendulum-v1")), 3)
    _assert_same_steps(got, want)
    dones = [s[2] for s in got if isinstance(s, tuple)]
    assert dones.index(True) == 199 and [s[3] for s in got if isinstance(s, tuple)][199]


def test_builder_falls_back_to_gymnasium_like_the_original():
    from pointcloud_rl_torch.env import build_env as t_build_env
    from pointcloud_rl_torch.env.gym_adapter import GymnasiumAdapter
    from pointcloud_rl_tpu.env import build_env as j_build_env

    cfg = dict(type="gym", env_name="Pendulum-v1", obs_mode="state")
    ours = t_build_env(cfg)
    assert any(isinstance(e, GymnasiumAdapter) for e in _chain(ours))
    _assert_same_steps(_drive(ours, 5), _drive(j_build_env(cfg), 5))
    for build in (t_build_env, j_build_env):
        with pytest.raises(KeyError, match="Unknown env"):
            build(dict(type="gym", env_name="NoSuchEnv-v0", obs_mode="state"))


def _chain(env):
    while env is not None:
        yield env
        env = getattr(env, "env", None)


def test_version_is_the_originals():
    import pointcloud_rl_torch
    import pointcloud_rl_tpu

    assert pointcloud_rl_torch.__version__ == pointcloud_rl_tpu.__version__


def _agents():
    from pointcloud_rl_torch.algorithms import build_agent as t_build_agent
    from pointcloud_rl_torch.convert import params_from_jax
    from pointcloud_rl_tpu.algorithms import build_agent as j_build_agent

    agent_cfg, env_info, _ = slice_setup(fused=True)
    j_agent = j_build_agent(dict(agent_cfg, env_params=env_info, seed=0))
    t_agent = t_build_agent(dict(agent_cfg, env_params=env_info, seed=0, device="cpu"))
    st = j_agent.train_state
    t_agent.load_params(params_from_jax(st.params, st.target_params, st.log_alpha))
    return t_agent, j_agent


def test_count_params_matches_the_original():
    from pointcloud_rl_torch.utils.flops import count_params
    from pointcloud_rl_tpu.utils.flops import count_params as j_count_params

    t_agent, j_agent = _agents()
    want = j_count_params(j_agent.train_state.params)
    assert count_params(t_agent.model) == want == t_agent.num_params
    tree = {k: v.numpy() for k, v in t_agent.model.state_dict().items()}
    assert count_params(tree) == want


def test_products_cost_what_xla_counts():
    """A product: FlopCounterMode and XLA's cost analysis give 2*M*N*K; XLA
    also counts the elementwise tanh and add after it, FlopCounterMode not."""
    import jax.numpy as jnp

    from pointcloud_rl_torch.utils.flops import cost_analysis
    from pointcloud_rl_tpu.utils.flops import cost_analysis as j_cost_analysis

    a, b = np.ones((8, 16), np.float32), np.ones((16, 4), np.float32)
    assert cost_analysis(torch.matmul, torch.as_tensor(a), torch.as_tensor(b)) == {"flops": 2 * 8 * 16 * 4}
    assert j_cost_analysis(lambda x, y: x @ y, a, b)["flops"] == 2 * 8 * 16 * 4
    assert cost_analysis(lambda x, y: torch.tanh(x @ y) + 1, torch.as_tensor(a), torch.as_tensor(b))["flops"] \
        == 2 * 8 * 16 * 4 < j_cost_analysis(lambda x, y: jnp.tanh(x @ y) + 1, a, b)["flops"]


def test_pointnet_and_actor_flops_are_their_products():
    """The PointNet forward: 2*B*N*(C_in*c1 + c1*c2 + c2*c3) for the body
    (the fused body's plain version, on the CPU) and 2*B*c3*out for its
    final Dense; the actor adds the products of its MLP head."""
    from pointcloud_rl_torch.utils.flops import estimate_flops, model_report

    t_agent, _ = _agents()
    B = 4
    obs = {k: torch.as_tensor(v) for k, v in slice_obs(0, B).items()}
    n, c_in = obs["xyz"].shape[-1], 8
    c1, c2, c3 = TINY["agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.mlp_spec"]
    out = TINY["agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.out_channels"]
    pointnet = 2 * B * n * (c_in * c1 + c1 * c2 + c2 * c3) + 2 * B * c3 * out
    head_in, h1, h2, act2 = out + 32, 32, 32, 16  # the tiny slice's actor MLP: [16 + state, 32, 32, 2 * 8]
    actor = pointnet + 2 * B * (head_in * h1 + h1 * h2 + h2 * act2)
    with torch.no_grad():
        got = estimate_flops(lambda o: t_agent.model.actor_apply(o, mode="eval"), obs)
    assert got == actor
    encoder, = [m for m in t_agent.model.modules() if type(m).__name__ == "PointNet"]
    assert model_report(encoder, obs) == {"params": sum(p.numel() for p in encoder.parameters()), "flops": pointnet}


def test_visualization_helpers_match_the_original():
    from pointcloud_rl_torch.utils import visualization as t_vis
    from pointcloud_rl_tpu.utils import visualization as j_vis

    rs = np.random.RandomState(0)
    values = rs.randn(50)
    np.testing.assert_array_equal(t_vis.values_to_colors(values), j_vis.values_to_colors(values))
    f1, f2 = rs.randn(60, 5), rs.randn(60, 5)
    np.testing.assert_array_equal(t_vis.feature_similarity(f1, f2, batchsize=16, k=8),
                                  j_vis.feature_similarity(f1, f2, batchsize=16, k=8))
    for a, b in zip(t_vis.kmeans(f1, n_clusters=3, seed=2), j_vis.kmeans(f1, n_clusters=3, seed=2)):
        np.testing.assert_array_equal(a, b)
    center = rs.randn(4, 5)
    for a, b in zip(t_vis.kmeans(f2, center=center), j_vis.kmeans(f2, center=center)):
        np.testing.assert_array_equal(a, b)


def test_plots_write_pngs(tmp_path):
    pytest.importorskip("matplotlib")
    from pointcloud_rl_torch.utils import visualization as t_vis

    xyz = np.random.RandomState(1).rand(3, 100).astype(np.float32)
    rgb = np.random.RandomState(2).randint(0, 256, (3, 100)).astype(np.uint8)
    png = t_vis.plot_pointcloud(xyz, rgb, save_path=str(tmp_path / "cloud.png"))
    with open(tmp_path / "metrics.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["step", "train/env/rewards_mean", "train/sac/critic_loss"])
        writer.writeheader()
        for step in range(1, 11):
            writer.writerow({"step": 32 * step, "train/env/rewards_mean": -10 + step,
                             "train/sac/critic_loss": 1 / step})
    curves = t_vis.plot_learning_curves(str(tmp_path / "metrics.csv"), save_path=str(tmp_path / "curves.png"))
    for path in (png, curves):
        with open(path, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
