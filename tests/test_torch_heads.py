"""The port's regression heads and distribution helpers against the JAX
package's: every head, every mode part, with the draws injected.

Both sides see the same feature, the same head parameters (random values,
carried over by ``convert.params_from_jax``) and the same noise: the JAX
distributions' ``jax.random.normal`` and the port's ``standard_normal``
return one numpy array, the categorical draw one set of Gumbel noise.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_rl_torch.convert import params_from_jax
from pointcloud_rl_torch.models import distributions as td
from pointcloud_rl_torch.models import heads as t_heads
from pointcloud_rl_tpu.models import distributions as jd
from pointcloud_rl_tpu.models import heads as j_heads

torch.set_num_threads(1)

B, A = 6, 4
BOUND = [-np.ones(A, np.float32), 2 * np.ones(A, np.float32)]
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
# log-probs where tanh saturates: 1 - tanh(z)^2 keeps few significant bits,
# and the two frameworks' tanh differ in the last one.
LOGP_TOL = dict(rtol=1e-3, atol=1e-4)
CONTINUOUS_MODES = ["eval", "mean", "explore", "sample", "max-entropy", "std", "dist", "entropy",
                    "mean_std_entropy", "explore_dist"]
HEADS = [
    ("TanhGaussianHead", dict(bound=BOUND, log_std_bound=(-10, 2))),
    ("TanhGaussianHead", dict(bound=None)),
    ("TanhGaussianHead", dict(bound=BOUND, predict_std=False, init_log_std=-1.0)),
    ("GaussianHead", dict(bound=BOUND)),
    ("GaussianHead", dict(bound=None, clip_return=False)),
    ("GaussianHead", dict(bound=BOUND, predict_std=False)),
    ("SoftplusGaussianHead", dict(bound=BOUND)),
    ("SoftplusGaussianHead", dict(bound=BOUND, clip_return=True)),
    ("BasicHead", dict(bound=BOUND, clip_return=True)),
    ("BasicHead", dict(bound=None)),
    ("TanhHead", dict(bound=BOUND)),
]
HEAD_IDS = ["tanh_gaussian", "tanh_gaussian_unbounded", "tanh_gaussian_learned_std", "gaussian",
            "gaussian_unbounded", "gaussian_learned_std", "softplus", "softplus_clipped", "basic_clipped",
            "basic", "tanh"]


def _pin_normal(monkeypatch, eps):
    """Both frameworks' standard normal draws return ``eps``."""
    fake_random = types.SimpleNamespace(normal=lambda key, shape, dtype=None: jnp.asarray(eps, dtype).reshape(shape))
    monkeypatch.setattr(jd, "jax", types.SimpleNamespace(random=fake_random, nn=jax.nn))
    monkeypatch.setattr(td, "standard_normal", lambda like, generator: torch.from_numpy(eps).to(like.dtype))


def _pair(kind, kwargs, seed=0):
    j_head = getattr(j_heads, kind)(dim_output=A, **kwargs)
    t_head = getattr(t_heads, kind)(dim_output=A, **kwargs)
    width = 2 * A if kwargs.get("predict_std", True) and "Gaussian" in kind else A
    feature = jnp.zeros((B, width), jnp.float32)
    variables = j_head.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, feature, mode="eval")
    rs = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(lambda v: (rs.randn(*v.shape) * 0.5).astype(np.float32),
                                    dict(variables.get("params", {})))
    t_head.load_state_dict(params_from_jax(params))
    return j_head, params, t_head, width


def _flat(out):
    """A head's output as a flat list of arrays (dist parts are tuples)."""
    out = out if isinstance(out, tuple) else (out,)
    flat = []
    for o in out:
        flat.extend(o if isinstance(o, tuple) else (o,))
    return flat


def _modes(kind):
    if kind in ("BasicHead", "TanhHead"):
        return ["eval", "mean", "explore"]
    return CONTINUOUS_MODES


@pytest.mark.parametrize("kind,kwargs", HEADS, ids=HEAD_IDS)
def test_continuous_head_matches_jax_in_every_mode(kind, kwargs, monkeypatch):
    j_head, params, t_head, width = _pair(kind, kwargs)
    rs = np.random.RandomState(1)
    # unit-scale features: where |z| > ~5, 1 - tanh(z)^2 holds no f32 bit
    # the two frameworks' tanh agree on, and the log-prob any value near
    # log(eps); test_tanh_log_prob_saturates_alike checks that region.
    feature = rs.randn(B, width).astype(np.float32)
    eps = rs.randn(B, A).astype(np.float32)
    _pin_normal(monkeypatch, eps)
    for mode in _modes(kind):
        want = _flat(j_head.apply({"params": params}, jnp.asarray(feature), mode=mode,
                                  rngs={"sample": jax.random.PRNGKey(2)}))
        with torch.no_grad():
            got = _flat(t_head(torch.from_numpy(feature), mode=mode, generator=None))
        assert len(got) == len(want), mode
        for i, (g, w) in enumerate(zip(got, want)):
            assert tuple(g.shape) == np.shape(w), f"{mode} part {i}: {tuple(g.shape)} vs {np.shape(w)}"
            tol = LOGP_TOL if (mode == "max-entropy" and i == 1) else FWD_TOL
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol, err_msg=f"{kind} {mode} part {i}")
    if kind not in ("BasicHead", "TanhHead"):
        # "log_std" splits into "log" and "std": both packages raise on "log"
        with pytest.raises(KeyError):
            j_head.apply({"params": params}, jnp.asarray(feature), mode="log_std")
        with pytest.raises(KeyError):
            t_head(torch.from_numpy(feature), mode="log_std")


@pytest.mark.parametrize("kind,kwargs", [HEADS[2], HEADS[5], HEADS[6]],
                         ids=["tanh_gaussian_learned_std", "gaussian_learned_std", "softplus"])
def test_head_parameter_gradients_match_jax(kind, kwargs, monkeypatch):
    """The heads' own parameters (learned log_std, the softplus bounds)
    get the JAX gradients of the max-entropy sample and its log-prob."""
    j_head, params, t_head, width = _pair(kind, kwargs, seed=3)
    rs = np.random.RandomState(4)
    feature = rs.randn(B, width).astype(np.float32)
    eps = rs.randn(B, A).astype(np.float32)
    _pin_normal(monkeypatch, eps)

    def j_loss(p):
        a, nlp = j_head.apply({"params": p}, jnp.asarray(feature), mode="max-entropy",
                              rngs={"sample": jax.random.PRNGKey(0)})
        return a.sum() + nlp.sum()

    want = params_from_jax(jax.device_get(jax.grad(j_loss)(params)))
    a, nlp = t_head(torch.from_numpy(feature), mode="max-entropy")
    (a.sum() + nlp.sum()).backward()
    assert set(want) == {n for n, _ in t_head.named_parameters()}
    for name, p in t_head.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-5, err_msg=name)


DISCRETE_MODES = ["eval", "mean", "greedy", "explore", "sample", "p", "prob", "entropy", "logits", "feature",
                  "max-entropy", "greedy_p_entropy"]


@pytest.mark.parametrize("num_heads", [1, 2])
def test_discrete_head_matches_jax_in_every_mode(num_heads, monkeypatch):
    n = 5
    rs = np.random.RandomState(5)
    logits = (rs.randn(B, n * num_heads) * 2).astype(np.float32)
    gumbel = rs.gumbel(size=logits.shape).astype(np.float32)
    # the categorical draw, Gumbel-max on both sides with the same noise
    fake_random = types.SimpleNamespace(
        categorical=lambda key, lg, axis=-1: jnp.argmax(lg + jnp.asarray(gumbel), axis=axis))
    monkeypatch.setattr(jd, "jax", types.SimpleNamespace(random=fake_random, nn=jax.nn))
    monkeypatch.setattr(td, "standard_gumbel", lambda like, generator: torch.from_numpy(gumbel))
    j_head = j_heads.DiscreteBaseHead(num_choices=n, num_heads=num_heads)
    t_head = t_heads.DiscreteBaseHead(num_choices=n, num_heads=num_heads)
    for mode in DISCRETE_MODES:
        if num_heads > 1 and mode not in ("logits", "feature"):
            continue  # the JAX head's other parts treat the last axis as one categorical
        want = _flat(j_head.apply({}, jnp.asarray(logits), mode=mode, rngs={"sample": jax.random.PRNGKey(0)}))
        got = _flat(t_head(torch.from_numpy(logits), mode=mode))
        assert len(got) == len(want), mode
        for g, w in zip(got, want):
            assert tuple(g.shape) == np.shape(w), mode
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD_TOL, err_msg=mode)


def test_categorical_helpers_match_jax():
    rs = np.random.RandomState(6)
    logits = (rs.randn(7, 5) * 3).astype(np.float32)
    actions = rs.randint(0, 5, (7, 1))
    tl = torch.from_numpy(logits)
    np.testing.assert_allclose(td.categorical_probs(tl).numpy(), np.asarray(jd.categorical_probs(logits)), **FWD_TOL)
    np.testing.assert_allclose(td.categorical_entropy(tl).numpy(), np.asarray(jd.categorical_entropy(logits)),
                               **FWD_TOL)
    for acts in (actions, actions[:, 0]):
        np.testing.assert_allclose(td.categorical_log_prob(tl, torch.from_numpy(acts)).numpy(),
                                   np.asarray(jd.categorical_log_prob(logits, acts)), **FWD_TOL)


def test_normal_helpers_match_jax():
    rs = np.random.RandomState(7)
    mean, std = rs.randn(5, A).astype(np.float32), np.exp(rs.randn(5, A)).astype(np.float32)
    scale, bias = np.float32([1.5, 1.5, 0.5, 0.5]), np.float32([0.5, 0.5, 0.0, -0.2])
    x = np.tanh(rs.randn(5, A)).astype(np.float32) * scale * 0.9 + bias
    t = [torch.from_numpy(v) for v in (x, mean, std, scale, bias)]
    np.testing.assert_allclose(td.normal_entropy(t[2]).numpy(), np.asarray(jd.normal_entropy(std)), **FWD_TOL)
    np.testing.assert_allclose(td.scaled_normal_log_prob(*t).numpy(),
                               np.asarray(jd.scaled_normal_log_prob(x, mean, std, scale, bias)), **FWD_TOL)
    np.testing.assert_allclose(td.tanh_normal_log_prob(*t).numpy(),
                               np.asarray(jd.tanh_normal_log_prob(x, mean, std, scale, bias)), **LOGP_TOL)


def test_categorical_sample_draws_the_softmax():
    """Gumbel-max from the port's generator: the frequencies of 20000
    draws are the softmax probabilities (5 sigma)."""
    logits = torch.tensor([[0.3, -1.0, 2.0, 0.0]]).expand(20000, 4)
    draws = td.categorical_sample(torch.Generator().manual_seed(0), logits)
    freq = torch.bincount(draws, minlength=4).double() / 20000
    p = torch.softmax(logits[0].double(), -1)
    assert torch.all((freq - p).abs() < 5 * torch.sqrt(p * (1 - p) / 20000)), (freq, p)


def test_tanh_log_prob_saturates_alike():
    """Deep in tanh's saturation both packages' log-prob correction sits at
    the epsilon floor, -log(scale * (1 - tanh^2) + 1e-6) ~ log(1e6) per
    action, within a few percent of each other."""
    z = np.float32([[6.0, -7.0, 9.0, 12.0]])
    mean, std, scale = np.zeros_like(z), np.ones_like(z), np.full_like(z, 1.5)
    want = np.asarray(jd.tanh_log_prob_with_logit(z, mean, std, scale))
    got = td.tanh_log_prob_with_logit(*(torch.from_numpy(v) for v in (z, mean, std, scale))).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2)
