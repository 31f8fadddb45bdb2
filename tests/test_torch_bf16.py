"""The bf16 agent flag: the port's bf16 models against the JAX package's.

``bf16=True`` computes every MLP's and the PointNet's matmuls in bf16
(parameters, LayerNorms, heads and losses stay f32).  Both packages start
from one parameter set (``params_from_jax``; the parameters are f32 in
both) and see the same observations, raw or packed in bf16 as a device
replay stores them.

Tolerance: both packages round at the same points (each product to bf16,
then the bias add to bf16) and sum in f32, so they mostly agree to f32
noise.  But a sum in another order may land on the other side of a
bf16 rounding step, 2^-8 (0.4%) relative for that element; the tolerance
leaves room for a few such flips along the encoder and the 3-layer heads:
1e-2 relative, 1e-3 absolute.
"""

import os.path as osp
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, osp.dirname(__file__))

from test_torch_models import DRQ_CONFIG, FWD_TOL, _split_cfg, jax_leaf, slice_obs, slice_setup  # noqa: E402

from pointcloud_rl_torch.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)

BF16_TOL = dict(rtol=1e-2, atol=1e-3)


def _t(obs):
    return {k: torch.from_numpy(np.array(v)) for k, v in obs.items()}


def _pair(fused, bf16=True):
    from pointcloud_rl_torch.algorithms.base import example_obs_from_shape
    from pointcloud_rl_torch.models import build_actor_critic as t_build
    from pointcloud_rl_tpu.models import build_actor_critic as j_build

    agent_cfg, env_info, _ = slice_setup(fused=fused)
    actor_cfg, critic_cfg = _split_cfg(agent_cfg)
    j_model = j_build(actor_cfg, critic_cfg, env_info, shared_backbone=True, bf16=bf16)
    params = j_model.init_params(jax.random.PRNGKey(0), example_obs_from_shape(env_info["obs_shape"]),
                                 np.zeros((1, 8), np.float32))
    t_model = t_build(actor_cfg, critic_cfg, env_info, shared_backbone=True, bf16=bf16,
                      generator=torch.Generator().manual_seed(0))
    t_model.load_state_dict(params_from_jax(params))
    return j_model, params, t_model


@pytest.mark.parametrize("packed", [False, True], ids=["raw_obs", "packed_bf16"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_bf16_actor_and_critic_match_jax(fused, packed):
    from pointcloud_rl_tpu.algorithms.obs_transfer import pack_device_features

    j_model, params, t_model = _pair(fused)
    assert t_model.visual.compute_dtype == torch.bfloat16
    assert t_model.critic.VmapMLP_0.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in t_model.parameters())
    obs = slice_obs(2, 6)
    t_obs = _t(obs)
    if packed:
        obs = {k: np.asarray(v) for k, v in pack_device_features(obs, jnp.bfloat16).items()}
        t_obs = {"pcd": torch.from_numpy(np.array(obs["pcd"].astype(np.float32))).bfloat16(),
                 "state": torch.from_numpy(np.array(obs["state"]))}
    actions = np.clip(np.random.RandomState(3).randn(6, 8), -1, 1).astype(np.float32)
    j_act, j_feat = j_model.actor_apply(params, obs, mode="eval")
    j_q = j_model.critic_apply(params, obs, actions=jnp.asarray(actions))
    with torch.no_grad():
        t_act, t_feat = t_model.actor_apply(t_obs, mode="eval")
        t_q = t_model.critic_apply(t_obs, actions=torch.from_numpy(actions))
    for got, want in ((t_feat, j_feat), (t_act, j_act), (t_q, j_q)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BF16_TOL)
    # and bf16 is not f32: the f32 model differs by more than f32 noise
    _, _, f32_model = _pair(fused, bf16=False)
    f32_model.load_state_dict(t_model.state_dict())
    with torch.no_grad():
        f32_q = f32_model.critic_apply(_t(slice_obs(2, 6)), actions=torch.from_numpy(actions))
    if not packed:
        assert float((f32_q - t_q).abs().max()) > 1e-5


def test_jax_bf16_drq_agent_carries_across():
    """``params_from_jax`` loads a JAX DrQ agent with ``bf16=True`` (an f32
    tree, the same as SAC's): every leaf lands, in f32, and the two agents
    act alike in eval mode."""
    from pointcloud_rl_torch.algorithms import build_agent as t_build_agent
    from pointcloud_rl_tpu.algorithms import build_agent as j_build_agent

    agent_cfg, env_info, _ = slice_setup(fused=True, config=DRQ_CONFIG, bf16=True)
    j_agent = j_build_agent(dict(agent_cfg, env_params=env_info, seed=0))
    t_agent = t_build_agent(dict(agent_cfg, env_params=env_info, seed=0, device="cpu"))
    st = j_agent.train_state
    sd = params_from_jax(st.params, st.target_params, st.log_alpha)
    assert all(v.dtype == torch.float32 for v in sd.values())
    t_agent.load_params(sd)
    params = jax.device_get(st.params)
    for name, value in t_agent.model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), jax_leaf(params, name), err_msg=name)
    obs = slice_obs(4, 5)
    np.testing.assert_allclose(t_agent.forward(obs, mode="eval"), np.asarray(j_agent.forward(obs, mode="eval")),
                               **BF16_TOL)


def test_an_explicit_dtype_wins_over_the_flag():
    """The flag sets ``dtype`` only where a config leaves it unset (as the
    JAX builder's setdefault does); an f32 MLP promotes a bf16 input to f32."""
    from pointcloud_rl_torch.models import build_actor_critic
    from pointcloud_rl_torch.models.blocks import MLP

    agent_cfg, env_info, _ = slice_setup(fused=True)
    actor_cfg, critic_cfg = _split_cfg(agent_cfg)
    actor_cfg["nn_cfg"]["visual_nn_cfg"]["dtype"] = "float32"
    model = build_actor_critic(actor_cfg, critic_cfg, env_info, shared_backbone=True, bf16=True)
    assert model.visual.compute_dtype is None
    assert model.actor.final_mlp.compute_dtype == torch.bfloat16
    mlp = MLP([8, 16, 4], generator=torch.Generator().manual_seed(0))
    x = torch.randn(3, 8).bfloat16()
    with torch.no_grad():
        np.testing.assert_allclose(mlp(x).numpy(), mlp(x.float()).numpy(), **FWD_TOL)
