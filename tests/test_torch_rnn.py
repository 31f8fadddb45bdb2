"""The port's GRU against the JAX package's (flax ``GRUCell`` per layer).

One parameter set, made by the JAX init and carried over by
``convert.params_from_jax``, and numpy inputs: step mode with a reset,
sequence mode with a done in mid-sequence, one and two layers, both
``rnn_mode``s, and the gradients of a weighted sum of the outputs with
respect to every parameter and the input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_rl_torch.convert import params_from_jax
from pointcloud_rl_torch.models import build_all as t_build_all
from pointcloud_rl_tpu.models import build_all as j_build_all

torch.set_num_threads(1)

B, T, D, H = 3, 5, 7, 6
# f32 sums of a few small products per gate, through at most 5 steps.
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _pair(num_layers, kind="GRU"):
    cfg = dict(type=kind, hidden_size=H, num_layers=num_layers)
    j_gru = j_build_all(cfg)
    x0 = jnp.zeros((B, D), jnp.float32)
    jparams = j_gru.init({"params": jax.random.PRNGKey(num_layers)}, x0)["params"]
    t_gru = t_build_all(dict(cfg, in_features=D), generator=torch.Generator().manual_seed(0))
    t_gru.load_state_dict(params_from_jax(jparams))
    return j_gru, jparams, t_gru


def _inputs(seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, T, D).astype(np.float32), rs.randn(B, 2, H).astype(np.float32),
            rs.randn(B, T, H).astype(np.float32))


def test_names_and_shapes_are_the_flax_cells():
    """Six Dense layers per cell, named as flax names them; no trainable
    bias in hr and hz (torch.nn.GRUCell would train one)."""
    _, jparams, t_gru = _pair(2)
    names = set(t_gru.state_dict())
    assert len(names) == len(jax.tree_util.tree_leaves(jparams)) == 2 * 10
    assert "layer_1.hr.bias" not in names and "layer_0.hz.bias" not in names
    assert {"layer_0.in.bias", "layer_0.hn.bias", "layer_1.ir.weight"} <= names


@pytest.mark.parametrize("num_layers", [1, 2])
@pytest.mark.parametrize("kind", ["GRU", "RNN"])
def test_step_matches_flax(num_layers, kind):
    j_gru, jparams, t_gru = _pair(num_layers, kind)
    x, _, _ = _inputs(1)
    state = np.random.RandomState(2).randn(B, num_layers, H).astype(np.float32)
    dones = np.array([[1.0], [0.0], [1.0]], np.float32)
    j_out, j_state = j_gru.apply({"params": jparams}, x[:, 0], rnn_states=state, episode_dones=dones,
                                 rnn_mode="with_states")
    with torch.no_grad():
        t_out, t_state = t_gru(torch.from_numpy(x[:, 0]), rnn_states=torch.from_numpy(state),
                               episode_dones=torch.from_numpy(dones), rnn_mode="with_states")
        t_base = t_gru(torch.from_numpy(x[:, 0]))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **FWD_TOL)
    np.testing.assert_allclose(t_state.numpy(), np.asarray(j_state), **FWD_TOL)
    # no state: the zero initial state, base mode returns the features only
    np.testing.assert_allclose(t_base.numpy(), np.asarray(j_gru.apply({"params": jparams}, x[:, 0])), **FWD_TOL)
    # the reset rows start from zeros, whatever state they held
    np.testing.assert_allclose(t_out.numpy()[0], t_base.numpy()[0], **FWD_TOL)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_sequence_with_a_done_in_mid_sequence_matches_flax(num_layers):
    j_gru, jparams, t_gru = _pair(num_layers)
    x, _, w = _inputs(3)
    state = np.random.RandomState(4).randn(B, num_layers, H).astype(np.float32)
    dones = np.zeros((B, T), np.float32)
    dones[0, 2] = 1.0  # row 0 resets before step 2
    dones[2, 4] = 1.0

    def j_loss(p, xx):
        out, fin = j_gru.apply({"params": p}, xx, rnn_states=state, episode_dones=dones, rnn_mode="with_states")
        return (out * w).sum() + fin.sum(), (out, fin)

    (_, (j_out, j_fin)), (j_gp, j_gx) = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(jparams, x)
    tx = torch.from_numpy(x).requires_grad_(True)
    t_out, t_fin = t_gru(tx, rnn_states=torch.from_numpy(state), episode_dones=torch.from_numpy(dones),
                         rnn_mode="with_states")
    ((t_out * torch.from_numpy(w)).sum() + t_fin.sum()).backward()
    assert tuple(t_out.shape) == (B, T, H) and tuple(t_fin.shape) == (B, num_layers, H)
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), **FWD_TOL)
    np.testing.assert_allclose(t_fin.detach().numpy(), np.asarray(j_fin), **FWD_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(j_gx), **GRAD_TOL)
    want = params_from_jax(jax.device_get(j_gp))
    for name, p in t_gru.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), **GRAD_TOL, err_msg=name)
    # base mode gives the same features
    with torch.no_grad():
        again = t_gru(torch.from_numpy(x), rnn_states=torch.from_numpy(state), episode_dones=torch.from_numpy(dones))
    np.testing.assert_array_equal(again.numpy(), t_out.detach().numpy())
