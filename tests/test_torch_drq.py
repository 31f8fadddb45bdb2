"""The port's DrQ / SVEA update against the JAX package's, step for step.

Both agents are built from ``pn_jitter_fake_manipulation.py`` (DrQ,
``num_aug=2``, a ``RandomJitterPoints`` on xyz) at test size; the port's
parameters come from the JAX agent through ``params_from_jax``; a
fixed-batch memory feeds both.  The Gaussian noise is pinned to zero as
``tests/test_torch_sac.py`` pins it, and the jitter's draw is pinned to
the same fixed noise on both sides (the n-th augmentation call of an update
gets the n-th noise array).  Four updates exercise the actor and target
gating of interval 2.  Also: the packed-storage path (a device replay's
``{"pcd": bf16}`` batch), SAC's ``pre_process`` and DrQ's ``inference_aug``.
"""

import os.path as osp
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, osp.dirname(__file__))

from test_torch_models import DRQ_CONFIG, jax_leaf, slice_obs, slice_setup  # noqa: E402
from test_torch_sac import B, LR, METRIC_RTOL, N_UPDATES, _batch, _FixedMemory, _pin_noise  # noqa: E402

from pointcloud_rl_torch.convert import params_from_jax  # noqa: E402
from pointcloud_rl_torch.ops import augment as ta  # noqa: E402
from pointcloud_rl_tpu.ops import augment as ja  # noqa: E402

torch.set_num_threads(1)

def _fixed_noise(shape, i):
    rs = np.random.RandomState(17 * i + int(np.prod(shape)) % 1009)
    return rs.uniform(-0.01, 0.01, tuple(shape)).astype(np.float32)


def _pin_jitter(monkeypatch, calls_per_update):
    """Both packages' jitter adds ``_fixed_noise(shape, n)`` at the n-th
    call of an update (the JAX update is traced once, in the same order)."""
    counts = {"jax": 0, "torch": 0}

    def j_apply(self, data, key, info, rng):
        i = counts["jax"] % calls_per_update
        counts["jax"] += 1
        return data + jnp.asarray(_fixed_noise(data.shape, i)).astype(data.dtype)

    def t_draw(self, generator, shape, device):
        i = counts["torch"] % calls_per_update
        counts["torch"] += 1
        return torch.from_numpy(_fixed_noise(shape, i)).to(device)

    monkeypatch.setattr(ja.RandomJitterPoints, "apply_single", j_apply)
    monkeypatch.setattr(ta.RandomJitterPoints, "_draw_noise", t_draw)
    return counts


def _agents(**overrides):
    from pointcloud_rl_torch.algorithms import build_agent as t_build_agent
    from pointcloud_rl_tpu.algorithms import build_agent as j_build_agent

    agent_cfg, env_info, _ = slice_setup(fused=True, config=DRQ_CONFIG, **overrides)
    j_agent = j_build_agent(dict(agent_cfg, env_params=env_info, seed=0))
    t_agent = t_build_agent(dict(agent_cfg, env_params=env_info, seed=0, device="cpu"))
    st = j_agent.train_state
    t_agent.load_params(params_from_jax(st.params, st.target_params, st.log_alpha))
    return j_agent, t_agent


def _run_updates(j_agent, t_agent, j_memory, t_memory, n, prefix, rtol):
    for u in range(n):
        j_metrics = j_agent.update_parameters(j_memory, updates=u)
        t_metrics = t_agent.update_parameters(t_memory, updates=u)
        actor_step = u % 2 == 0
        keys = ["critic_loss", "q", "q_target", "alpha"] + (["actor_loss", "entropy"] if actor_step else [])
        for key in keys:
            a, b = j_metrics[f"{prefix}/{key}"], t_metrics[f"{prefix}/{key}"]
            assert abs(a - b) < rtol * (1 + abs(a)), f"update {u} {key}: jax {a} vs torch {b}"
        assert (f"{prefix}/actor_loss" in t_metrics) == actor_step
    assert t_agent.updates == n


def _assert_params_match(j_agent, t_agent, n_updates):
    """As in tests/test_torch_sac.py: every element inside the envelope of
    Adam's sign flips on ~0 gradients, and >90% of elements tight."""
    envelope = 2 * LR * n_updates * 1.01
    params = jax.device_get(j_agent.train_state.params)
    target = jax.device_get(j_agent.train_state.target_params)
    for name, value in t_agent.model.state_dict().items():
        diff = np.abs(value.numpy() - jax_leaf(params, name))
        assert diff.max() < envelope, f"{name}: max diff {diff.max()} outside the Adam envelope"
        assert (diff < 1e-4).mean() > 0.9, f"{name}: only {(diff < 1e-4).mean():.2%} of elements tight"
    for name, value in t_agent.target.state_dict().items():
        diff = np.abs(value.numpy() - jax_leaf(target, name))
        assert diff.max() < envelope * 0.02, f"target {name}: {diff.max()}"
    np.testing.assert_allclose(float(t_agent.log_alpha.detach()), float(j_agent.train_state.log_alpha), atol=1e-5)


@pytest.mark.parametrize("stale", [True, False], ids=["stale_feature", "fresh_feature"])
@pytest.mark.parametrize("svea", [False, True], ids=["drq_k2", "svea"])
def test_drq_updates_match_jax(svea, stale, monkeypatch):
    _pin_noise(monkeypatch)
    counts = _pin_jitter(monkeypatch, calls_per_update=1 if svea else 2)
    overrides = dict(num_aug=1, svea=True) if svea else {}
    j_agent, t_agent = _agents(stale_actor_feature=stale, **overrides)
    assert t_agent.num_aug == (1 if svea else 2) and t_agent.svea == svea and t_agent.metric_prefix == "drq"
    batch = _batch()
    _run_updates(j_agent, t_agent, _FixedMemory(batch), _FixedMemory(batch), N_UPDATES, "drq", METRIC_RTOL)
    assert counts["torch"] == N_UPDATES * (1 if svea else 2)
    _assert_params_match(j_agent, t_agent, N_UPDATES)


def _packed_batches(seed=3):
    """The same transitions as a JAX packed batch and as the port's device
    replay hands them out (tensors; pcd in bf16)."""
    from pointcloud_rl_tpu.algorithms.obs_transfer import pack_device_features

    batch = _batch(seed)
    j_batch, t_batch = dict(batch), {}
    for key in ("obs", "next_obs"):
        packed = pack_device_features(batch[key], jnp.bfloat16)
        j_batch[key] = {k: np.asarray(v) for k, v in packed.items()}
        t_batch[key] = {"pcd": torch.from_numpy(np.array(packed["pcd"].astype(jnp.float32))).bfloat16(),
                        "state": torch.from_numpy(np.array(packed["state"]))}
    for key in ("actions", "rewards", "dones", "episode_dones"):
        t_batch[key] = torch.from_numpy(np.array(batch[key]))
    return j_batch, t_batch


class _TensorMemory(_FixedMemory):
    def sample(self, batch_size):
        return {k: (dict(v) if isinstance(v, dict) else v.clone()) for k, v in self.batch.items()}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_drq_on_packed_storage_matches_jax(bf16, monkeypatch):
    """Mode (b)'s storage: the jitter runs on the packed tensor's xyz
    channels; with ``bf16`` the agent computes its matmuls in bf16.  Both
    packages round to bf16 at the same points (tests/test_torch_bf16.py),
    so the f32 tolerances hold for bf16 too."""
    _pin_noise(monkeypatch)
    _pin_jitter(monkeypatch, calls_per_update=2)
    j_agent, t_agent = _agents(bf16=bf16)
    j_batch, t_batch = _packed_batches()
    _run_updates(j_agent, t_agent, _FixedMemory(j_batch), _TensorMemory(t_batch), N_UPDATES, "drq", METRIC_RTOL)
    _assert_params_match(j_agent, t_agent, N_UPDATES)
    assert all(p.dtype == torch.float32 for p in t_agent.model.parameters())


def test_packed_storage_takes_only_xyz_augmentations():
    _, t_agent = _agents(obs_aug=dict(type="ColorJitterPoints"))
    _, t_batch = _packed_batches()
    with pytest.raises(ValueError, match="xyz-only"):
        t_agent.update_parameters(_TensorMemory(t_batch), updates=0)


def test_sac_pre_process_matches_jax(monkeypatch):
    """SAC's ``pre_process``: a GlobalRotScaleTrans on obs and next_obs,
    its draws pinned to fixed rotations and shifts on both sides."""
    from pointcloud_rl_torch.algorithms import build_agent as t_build_agent
    from pointcloud_rl_tpu.algorithms import build_agent as j_build_agent

    _pin_noise(monkeypatch)
    rs = np.random.RandomState(0)
    infos = []
    for _ in range(2):
        angle = rs.uniform(-0.5, 0.5, B)
        c, s = np.cos(angle), np.sin(angle)
        rot = np.zeros((B, 3, 3), np.float32)
        rot[:, 0, 0], rot[:, 0, 1], rot[:, 1, 0], rot[:, 1, 1], rot[:, 2, 2] = c, -s, s, c, 1.0
        infos.append((rot * rs.uniform(0.9, 1.1, (B, 3, 1)).astype(np.float32),
                      rs.uniform(-0.1, 0.1, (B, 3)).astype(np.float32)))
    counts = {"jax": 0, "torch": 0}

    def pinned(side, convert):
        def sample_info(self, generator, main_data):
            i = counts[side] % 2
            counts[side] += 1
            return tuple(convert(v) for v in infos[i])
        return sample_info

    monkeypatch.setattr(ja.GlobalRotScaleTrans, "sample_info", pinned("jax", jnp.asarray))
    monkeypatch.setattr(ta.GlobalRotScaleTrans, "sample_info", pinned("torch", torch.from_numpy))
    pre = dict(type="GlobalRotScaleTrans", translation_range=(0.1, 0.1, 0.1))
    agent_cfg, env_info, _ = slice_setup(fused=True, pre_process=pre)
    j_agent = j_build_agent(dict(agent_cfg, env_params=env_info, seed=0))
    t_agent = t_build_agent(dict(agent_cfg, env_params=env_info, seed=0, device="cpu"))
    st = j_agent.train_state
    t_agent.load_params(params_from_jax(st.params, st.target_params, st.log_alpha))
    batch = _batch()
    _run_updates(j_agent, t_agent, _FixedMemory(batch), _FixedMemory(batch), N_UPDATES, "sac", METRIC_RTOL)
    assert counts["torch"] == 2 * N_UPDATES
    _assert_params_match(j_agent, t_agent, N_UPDATES)


def test_inference_aug_in_act_matches_jax(monkeypatch):
    _pin_jitter(monkeypatch, calls_per_update=1)
    j_agent, t_agent = _agents(inference_aug="same")
    assert t_agent.inference_aug is t_agent.obs_aug
    obs = slice_obs(5, 4)
    want = np.asarray(j_agent.forward(obs, mode="eval"))
    got = t_agent.forward(obs, mode="eval")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    plain = _agents()[1]  # no inference_aug: the jitter changes the actions
    assert np.abs(plain.forward(obs, mode="eval") - got).max() > 1e-6


def test_svea_needs_one_augmentation():
    from pointcloud_rl_torch.algorithms import build_agent

    agent_cfg, env_info, _ = slice_setup(fused=True, config=DRQ_CONFIG, num_aug=2, svea=True)
    with pytest.raises(ValueError, match="SVEA"):
        build_agent(dict(agent_cfg, env_params=env_info, seed=0, device="cpu"))
