"""Port's IQN (loss, model, agent) vs the JAX package's.

Inputs are made with numpy from a seed; parameters are carried across by
``convert.iqn_net_state_dict`` / ``convert.iqn_state``; the JAX update's
three τ draws are recomputed from its key and injected into the port's
``update``.  Float32 throughout, tolerances: ``quantile_huber_loss`` atol
1e-6; ``IQNNet`` forward atol 1e-5; one update from identical state: loss,
``td_err`` and new parameters atol 1e-5 with the MLP ψ.  With the CNN ψ the
convolutions sum in another order, so loss and ``td_err`` are held to rtol
1e-4 and the Adam step as in ``test_torch_dqn``: to ``1e-3·lr`` wherever the
gradient is not within rounding of zero.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from border_tpu.agents import IQN as JaxIQN
from border_tpu.agents import IQNConfig as JaxIQNConfig
from border_tpu.agents.common import quantile_huber_loss as jax_qhl
from border_tpu.agents.iqn import sample_taus as jax_sample_taus
from border_tpu.core import spaces as jspaces
from border_tpu.models import AtariCNN as JaxAtariCNN
from border_tpu.models.iqn import IQNNet as JaxIQNNet
from border_tpu.replay.buffer import TransitionBatch as JaxBatch
from border_tpu_torch import convert
from border_tpu_torch.agents import IQN, IQNConfig
from border_tpu_torch.agents.common import quantile_huber_loss
from border_tpu_torch.agents.iqn import sample_taus
from border_tpu_torch.core import spaces
from border_tpu_torch.models import AtariCNN, IQNNet
from border_tpu_torch.replay import TransitionBatch

B, A = 8, 6
ATOL = 1e-5


def _assert_step_close(name, old, got, want, grad, lr):
    """Adam's first step is about ``lr·sign(g)``: both sides step by at most
    lr (up to float32 rounding), by the same amount to ``1e-3·lr`` wherever
    the gradient is not within rounding of zero, and by exactly 0 where it
    is exactly zero (dead ReLUs)."""
    d_got, d_want = got - old, want - old
    bound = lr * (1 + 1e-5) + 2 * np.spacing(np.abs(old))
    assert (np.abs(d_got) <= bound).all() and (np.abs(d_want) <= bound).all(), name
    stable = np.abs(grad) >= 1e-6
    np.testing.assert_allclose(d_got[stable], d_want[stable], rtol=0,
                               atol=1e-3 * lr, err_msg=name)
    zero = grad == 0
    assert (d_got[zero] == 0).all() and (d_want[zero] == 0).all(), name


@pytest.mark.parametrize("kappa", [1.0, 0.5])
def test_quantile_huber_loss_matches_jax(kappa):
    rng = np.random.default_rng(0)
    pred = rng.normal(size=(B, 5)).astype(np.float32) * 2
    tgt = rng.normal(size=(B, 7)).astype(np.float32) * 2
    tgt[0, 0] = pred[0, 0]  # u == 0: the indicator is u < 0, so 0 here
    taus = rng.random((B, 5)).astype(np.float32)
    want = jax_qhl(jnp.asarray(pred), jnp.asarray(tgt), jnp.asarray(taus), kappa)
    got = quantile_huber_loss(torch.from_numpy(pred), torch.from_numpy(tgt),
                              torch.from_numpy(taus), kappa)
    assert tuple(got.shape) == (B,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # mean over target quantiles, SUM over predicted ones
    one = quantile_huber_loss(torch.from_numpy(pred[:, :1]), torch.from_numpy(tgt),
                              torch.from_numpy(taus[:, :1]), kappa)
    both = quantile_huber_loss(
        torch.from_numpy(np.repeat(pred[:, :1], 2, 1)), torch.from_numpy(tgt),
        torch.from_numpy(np.repeat(taus[:, :1], 2, 1)), kappa)
    np.testing.assert_allclose(both.numpy(), 2 * one.numpy(), rtol=1e-6)


def test_sample_taus_strategies():
    key = jax.random.PRNGKey(0)
    for strategy, k in (("const32", 32), ("const4", 4), ("median", 1)):
        want = np.asarray(jax_sample_taus(strategy, key, 3))
        got = sample_taus(strategy, None, 3, "cpu")
        assert tuple(got.shape) == (3, k)
        np.testing.assert_array_equal(got.numpy(), want)
    u = sample_taus("uniform8", torch.Generator().manual_seed(0), 4096, "cpu")
    assert tuple(u.shape) == (4096, 8) and u.dtype == torch.float32
    assert 0 <= u.min() and u.max() < 1 and abs(u.mean().item() - 0.5) < 0.01
    with pytest.raises(ValueError):
        sample_taus("gauss", None, 1, "cpu")


def _nets(psi):
    if psi == "cnn":
        jnet = JaxIQNNet(out_dim=A, feature_dim=16, n_cos=8, f_hidden=(12,),
                         psi_fn=functools.partial(JaxAtariCNN, out_dim=0,
                                                  skip_linear=True,
                                                  dtype=jnp.float32))
        tnet = IQNNet(0, A, feature_dim=16, n_cos=8, f_hidden=(12,),
                      psi_fn=functools.partial(AtariCNN, out_dim=0,
                                               skip_linear=True,
                                               dtype=torch.float32))
        obs = np.random.default_rng(1).integers(0, 256, (B, 84, 84, 4),
                                                dtype=np.uint8)
    else:
        hidden = {"mlp": (10, 9), "mlp_flat": ()}[psi]
        jnet = JaxIQNNet(out_dim=A, feature_dim=16, n_cos=8, psi_hidden=hidden,
                         f_hidden=(12, 11))
        tnet = IQNNet(5, A, feature_dim=16, n_cos=8, psi_hidden=hidden,
                      f_hidden=(12, 11))
        obs = np.random.default_rng(1).normal(size=(B, 5)).astype(np.float32)
    return jnet, tnet, obs


@pytest.mark.parametrize("psi", ["mlp", "mlp_flat", "cnn"])
def test_iqn_net_forward_matches_flax(psi):
    jnet, tnet, obs = _nets(psi)
    taus = np.random.default_rng(2).random((B, 7)).astype(np.float32)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(obs), jnp.asarray(taus))
    # non-zero biases, so a swapped layer shows
    params = jax.tree.map(
        lambda p: p + 0.05 * jnp.cos(jnp.arange(p.size, dtype=p.dtype))
        if p.ndim == 1 else p, params)
    sd = convert.iqn_net_state_dict(tnet, params)
    assert set(sd) == set(tnet.state_dict())
    tnet.load_state_dict(sd)
    want = jnet.apply(params, jnp.asarray(obs), jnp.asarray(taus))
    got = tnet(torch.from_numpy(obs), torch.from_numpy(taus))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, 7, A)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    assert np.abs(np.asarray(want)).max() > 0.01


def _agents(psi):
    kw = dict(feature_dim=16, n_cos=8, hidden=(12,), soft_update_interval=2,
              tau=1.0, kappa=1.0)
    if psi == "cnn":
        kw["lr"] = 1e-4
        jcfg = JaxIQNConfig(psi_fn=functools.partial(
            JaxAtariCNN, out_dim=0, skip_linear=True, dtype=jnp.float32), **kw)
        tcfg = IQNConfig(psi_fn=functools.partial(
            AtariCNN, out_dim=0, skip_linear=True, dtype=torch.float32), **kw)
        shape, jdt, tdt = (84, 84, 4), jnp.uint8, torch.uint8
    else:
        jcfg, tcfg = JaxIQNConfig(**kw), IQNConfig(**kw)
        shape, jdt, tdt = (5,), jnp.float32, torch.float32
    jspace = jspaces.Box(0, 255, shape, jdt)
    jagent, tagent = JaxIQN(jcfg), IQN(tcfg)
    jst = jagent.init(jax.random.PRNGKey(0), jspace, jspaces.Discrete(A))
    other = jagent.net.init(jax.random.PRNGKey(1), jspace.zero()[None],
                            jnp.zeros((1, 8), jnp.float32))
    jst = jst.replace(target_params=other, n_samples=jnp.int32(40_000))
    tst = convert.iqn_state(tagent, jst, spaces.Box(0, 255, shape, tdt),
                            spaces.Discrete(A), device="cpu")
    return jagent, jst, tagent, tst


def _batch(seed, psi, weight=False):
    rng = np.random.default_rng(seed)
    if psi == "cnn":
        o = lambda: rng.integers(0, 256, (B, 84, 84, 4), dtype=np.uint8)  # noqa: E731
    else:
        o = lambda: rng.normal(size=(B, 5)).astype(np.float32)  # noqa: E731
    d = dict(obs=o(), act=rng.integers(0, A, B, dtype=np.int32), next_obs=o(),
             reward=rng.normal(size=B).astype(np.float32),
             terminated=rng.random(B) < 0.25, truncated=np.zeros(B, bool))
    w = (rng.random(B) + 0.5).astype(np.float32) if weight else None
    jb = JaxBatch(**{k: jnp.asarray(v) for k, v in d.items()},
                  weight=jnp.ones((B,), jnp.float32) if w is None else jnp.asarray(w),
                  ix_sample=jnp.arange(B, dtype=jnp.int32))
    tb = TransitionBatch(**{k: torch.from_numpy(v) for k, v in d.items()},
                         weight=None if w is None else torch.from_numpy(w))
    return jb, tb


def _jax_taus(jagent, key):
    c = jagent.config
    k_pred, k_tgt, k_act = jax.random.split(key, 3)
    return tuple(
        torch.from_numpy(np.array(jax_sample_taus(s, k, B)))
        for s, k in ((c.sample_percents_pred, k_pred),
                     (c.sample_percents_tgt, k_tgt),
                     (c.sample_percents_act, k_act)))


@pytest.mark.parametrize("psi", ["mlp", "cnn"])
def test_one_update_with_injected_taus_matches_jax(psi):
    jagent, jst, tagent, tst = _agents(psi)
    old = {k: v.clone().numpy() for k, v in tst.params.state_dict().items()}
    jb, tb = _batch(3, psi, weight=psi == "mlp")
    key = jax.random.PRNGKey(7)
    jst1, jm, jtd = jax.jit(jagent.update)(jst, jb, key)
    tst1, tm, ttd = tagent.update(tst, tb, taus=_jax_taus(jagent, key))

    tol = dict(atol=ATOL) if psi == "mlp" else dict(rtol=1e-4, atol=ATOL)
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), **tol)
    np.testing.assert_allclose(tm["q_mean"].item(), float(jm["q_mean"]), **tol)
    np.testing.assert_allclose(ttd.numpy(), np.asarray(jtd), **tol)
    # the jitted JAX update may fuse ε's multiply-add; op by op it is exact
    # (test_a_star_comes_from_the_target_net_and_actions_match)
    assert tuple(ttd.shape) == (B,)
    assert tm["epsilon"] == pytest.approx(float(jm["epsilon"]), abs=1e-6)
    new = convert.iqn_net_state_dict(tst1.params, jst1.params)
    lr = tagent.config.lr
    moved = 0.0
    for k, p in tst1.params.named_parameters():
        got, want = p.detach().numpy(), new[k].numpy()
        if psi == "mlp":
            np.testing.assert_allclose(got, want, atol=ATOL, err_msg=k)
        else:
            _assert_step_close(k, old[k], got, want, p.grad.numpy(), lr)
        moved = max(moved, np.abs(got - old[k]).max())
    assert moved > 0.5 * lr
    # the target net holds through update 1 (soft_update_interval = 2)
    tgt = convert.iqn_net_state_dict(tst1.target_params, jst.target_params)
    for k, v in tst1.target_params.state_dict().items():
        assert torch.equal(v, tgt[k]), k
    assert tst1.n_opts == int(jst1.n_opts) == 1

    # update 2 swaps the target (τ = 1) on both sides
    jb, tb = _batch(4, psi)
    key = jax.random.PRNGKey(8)
    jst2, _, _ = jax.jit(jagent.update)(jst1, jb, key)
    tst2, _, _ = tagent.update(tst1, tb, taus=_jax_taus(jagent, key))
    for k, v in tst2.target_params.state_dict().items():
        assert torch.equal(v, tst2.params.state_dict()[k]), k
    jt = convert.iqn_net_state_dict(tst2.target_params, jst2.target_params)
    jp = convert.iqn_net_state_dict(tst2.params, jst2.params)
    assert all(torch.equal(jt[k], jp[k]) for k in jt)


def test_a_star_comes_from_the_target_net_and_actions_match():
    """With τ for acting injected (const32 draws nothing), the greedy action
    agrees with JAX's; ε-greedy acts at random at ε = 1."""
    jagent, jst, tagent, tst = _agents("mlp")
    obs = np.random.default_rng(5).normal(size=(64, 5)).astype(np.float32)
    want = np.asarray(jagent.select_action_eval(jst, jnp.asarray(obs),
                                                jax.random.PRNGKey(0)))
    got = tagent.select_action_eval(tst, torch.from_numpy(obs))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and len(np.unique(want)) > 1
    for n in (0, 40_000, 250_000):
        tst.n_samples = n
        assert tagent.epsilon(tst) == float(
            jagent.epsilon(jst.replace(n_samples=jnp.int32(n))))
    tst.n_samples = 0
    gen = torch.Generator().manual_seed(0)
    acts = tagent.select_action(tst, torch.from_numpy(obs), gen)
    assert ((acts >= 0) & (acts < A)).all() and (acts.numpy() != want).any()
    tst.n_samples = 10 ** 7
    acts = tagent.select_action(tst, torch.from_numpy(obs), gen)
    assert (acts.numpy() == want).mean() >= 0.9
    assert tagent.on_env_step(tst, 5).n_samples == 10 ** 7 + 5
    # the update's own draws (no injection) run too
    _, tb = _batch(6, "mlp")
    _, metrics, td = tagent.update(tst, tb, gen)
    assert np.isfinite(metrics["loss"].item()) and torch.isfinite(td).all()
