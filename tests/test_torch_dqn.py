"""Port's DQN update vs the JAX package's, on the float32 Atari CNN.

Both sides start from identical parameters (carried across by
``convert.dqn_state``, with a target net that differs from the online one
so double DQN matters), a fresh Adam state and one batch made with numpy.

Tolerances, and why:

- loss, ``td_err`` and grads: rtol 1e-4 / atol 1e-6.  The two frameworks
  sum the convolutions in another order, in float32.
- new parameters: Adam's first step is ``lr·g/(|g| + 1e-8)``, about
  ``lr·sign(g)``.  Where a grad is close to 0 (|g| < 1e-6, e.g. from
  cancellation) rounding can move that ratio anywhere in ``[-lr, lr]``, so
  there the step is only held to ``|Δθ| ≤ lr`` on both sides (up to the
  float32 rounding of ``θ + Δθ``); everywhere
  else the steps agree to ``1e-3·lr``.  Exactly-zero grads (dead ReLUs)
  step by exactly 0 on both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from border_tpu.agents import DQN as JaxDQN
from border_tpu.agents import DQNConfig as JaxDQNConfig
from border_tpu.agents.common import CRITIC_LOSSES as JAX_LOSSES
from border_tpu.agents.common import bootstrap_discount as jax_bootstrap
from border_tpu.core import spaces as jspaces
from border_tpu.models import AtariCNN as JaxAtariCNN
from border_tpu.replay.buffer import TransitionBatch as JaxBatch
from border_tpu_torch import convert
from border_tpu_torch.agents import DQN, DQNConfig
from border_tpu_torch.agents.common import (
    make_optimizer,
    polyak_update,
    smooth_l1,
)
from border_tpu_torch.core import spaces
from border_tpu_torch.models import AtariCNN
from border_tpu_torch.replay import TransitionBatch

B, A = 8, 6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6

CONFIGS = {
    # the bench config (bench.py:167-168), with a 2-step target swap
    "bench": dict(lr=1e-4, double_dqn=True, soft_update_interval=2, tau=1.0),
    # the other knobs of the update
    "knobs": dict(lr=1e-3, double_dqn=False, loss="mse", clip_reward=0.5,
                  max_grad_norm=1.0, lr_decay_steps=4, lr_final_frac=0.5,
                  soft_update_interval=2, tau=1.0),
}


def _configs(name):
    kw = CONFIGS[name]
    jcfg = JaxDQNConfig(model=lambda n: JaxAtariCNN(n, dtype=jnp.float32), **kw)
    tcfg = DQNConfig(model=lambda n: AtariCNN(n, dtype=torch.float32), **kw)
    return JaxDQN(jcfg), DQN(tcfg)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return dict(
        obs=rng.integers(0, 256, (B, 84, 84, 4), dtype=np.uint8),
        act=rng.integers(0, A, B, dtype=np.int32),
        next_obs=rng.integers(0, 256, (B, 84, 84, 4), dtype=np.uint8),
        reward=rng.choice([-1.0, 0.0, 1.0], B).astype(np.float32),
        terminated=rng.random(B) < 0.25,
        truncated=np.zeros(B, bool),
    )


def _jbatch(d):
    return JaxBatch(**{k: jnp.asarray(v) for k, v in d.items()},
                    weight=jnp.ones((B,), jnp.float32),
                    ix_sample=jnp.arange(B, dtype=jnp.int32))


def _tbatch(d):
    return TransitionBatch(**{k: torch.from_numpy(v) for k, v in d.items()})


def _init_both(name):
    jagent, tagent = _configs(name)
    obs_space = jspaces.Box(0, 255, (84, 84, 4), jnp.uint8)
    jst = jagent.init(jax.random.PRNGKey(0), obs_space, jspaces.Discrete(A))
    other = jagent.net.init(jax.random.PRNGKey(1), obs_space.zero()[None])
    jst = jst.replace(target_params=other)
    tst = convert.dqn_state(
        tagent, jst, spaces.Box(0, 255, (84, 84, 4), torch.uint8),
        spaces.Discrete(A), device="cpu",
    )
    return jagent, jst, tagent, tst


def _jax_grads(jagent, jst, jb):
    """The JAX update's gradient (dqn.py:209-221), recomputed here because
    ``DQN.update`` does not return it."""
    c = jagent.config
    q_next_tgt = jagent.net.apply(jst.target_params, jb.next_obs)
    src = jst.params if c.double_dqn else jst.target_params
    a_star = jnp.argmax(jagent.net.apply(src, jb.next_obs), axis=-1)
    q_next = jnp.take_along_axis(q_next_tgt, a_star[:, None], -1)[:, 0]
    reward = jb.reward
    if c.clip_reward is not None:
        reward = jnp.clip(reward, -c.clip_reward, c.clip_reward)
    target = reward + jax_bootstrap(c.gamma, jb) * q_next

    def loss(p):
        q = jagent.net.apply(p, jb.obs)
        pred = jnp.take_along_axis(q, jb.act[:, None], -1)[:, 0]
        return jnp.mean(JAX_LOSSES[c.loss](pred, target))

    g = jax.grad(loss)(jst.params)
    if c.max_grad_norm is not None:
        g, _ = optax.clip_by_global_norm(c.max_grad_norm).update(g, None)
    return convert.atari_cnn_state_dict(g)


def _assert_step_close(name, old, got, want, grad, lr):
    d_got, d_want = got - old, want - old
    # |Δθ| ≤ lr, up to the float32 rounding of θ + Δθ
    bound = lr + 2 * np.spacing(np.abs(old))
    assert (np.abs(d_got) <= bound).all(), name
    assert (np.abs(d_want) <= bound).all(), name
    stable = np.abs(grad) >= 1e-6
    np.testing.assert_allclose(d_got[stable], d_want[stable], rtol=0,
                               atol=1e-3 * lr, err_msg=name)
    zero = grad == 0
    assert (d_got[zero] == 0).all() and (d_want[zero] == 0).all(), name


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_one_update_matches_jax(name):
    jagent, jst, tagent, tst = _init_both(name)
    old = {k: v.clone().numpy() for k, v in tst.params.state_dict().items()}
    d = _batch(0)
    jb = _jbatch(d)
    jgrads = _jax_grads(jagent, jst, jb)
    jst1, jm, jtd = jax.jit(jagent.update)(jst, jb, jax.random.PRNGKey(2))
    tst1, tm, ttd = tagent.update(tst, _tbatch(d))

    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                               rtol=GRAD_RTOL)
    np.testing.assert_allclose(tm["q_mean"].item(), float(jm["q_mean"]),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(ttd.numpy(), np.asarray(jtd),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert tm["epsilon"] == pytest.approx(float(jm["epsilon"]), abs=0)
    new = convert.atari_cnn_state_dict(jst1.params)
    lr = CONFIGS[name]["lr"]
    for k, p in tst1.params.named_parameters():
        grad = jgrads[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), grad, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
        _assert_step_close(k, old[k], p.detach().numpy(), new[k].numpy(),
                           grad, lr)
    assert tst1.n_opts == int(jst1.n_opts) == 1


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_target_swap_after_soft_update_interval(name):
    """soft_update_interval=2, τ=1: the target holds through update 1 and
    is the online net after update 2, on both sides."""
    jagent, jst, tagent, tst = _init_both(name)
    tgt0 = convert.atari_cnn_state_dict(jst.target_params)
    update = jax.jit(jagent.update)
    for i, seed in enumerate((3, 4)):
        d = _batch(seed)
        jst, _, _ = update(jst, _jbatch(d), jax.random.PRNGKey(seed))
        tst, _, _ = tagent.update(tst, _tbatch(d))
        jt = convert.atari_cnn_state_dict(jst.target_params)
        tt = tst.target_params.state_dict()
        if i == 0:
            for k in tgt0:
                assert torch.equal(tt[k], tgt0[k]) and torch.equal(jt[k], tgt0[k])
    jp = convert.atari_cnn_state_dict(jst.params)
    tp = tst.params.state_dict()
    lr = CONFIGS[name]["lr"]
    for k in jp:
        assert torch.equal(jt[k], jp[k]) and torch.equal(tt[k], tp[k]), k
        # two Adam steps: each element within 2·lr of the JAX value, and
        # all but the near-zero-grad elements (a sliver) within 1e-3·lr
        diff = (tt[k] - jt[k]).abs()
        assert diff.max().item() <= 2 * lr, k
        assert (diff > 1e-3 * lr).float().mean().item() <= 0.01, k


def test_epsilon_and_greedy_action_match():
    jagent, jst, tagent, tst = _init_both("bench")
    for n in (0, 12_345, 99_999, 250_000):
        want = float(jagent.epsilon(jst.replace(n_samples=jnp.int32(n))))
        tst.n_samples = n
        assert tagent.epsilon(tst) == want
    obs = _batch(5)["obs"]
    want = np.asarray(jagent.select_action_eval(jst, jnp.asarray(obs), None))
    got = tagent.select_action_eval(tst, torch.from_numpy(obs))
    np.testing.assert_array_equal(got.numpy(), want)
    # ε = 1 acts uniformly at random; ε = eps_final mostly greedily
    tst.n_samples = 0
    gen = torch.Generator().manual_seed(0)
    obs64 = torch.from_numpy(np.repeat(obs, 8, axis=0))
    acts = tagent.select_action(tst, obs64, gen)
    assert acts.dtype == torch.int32 and ((acts >= 0) & (acts < A)).all()
    tst.n_samples = 10 ** 7
    greedy = tagent.select_action_eval(tst, obs64)
    acts = tagent.select_action(tst, obs64, gen)
    assert (acts == greedy).float().mean().item() >= 0.9


def test_common_helpers():
    d = torch.tensor([-3.0, -0.5, 0.0, 0.25, 2.0])
    np.testing.assert_allclose(
        smooth_l1(d, torch.zeros(5)).numpy(),
        np.asarray(JAX_LOSSES["smooth_l1"](jnp.asarray(d.numpy()), 0.0)),
    )
    a, b = AtariCNN(6), AtariCNN(6)
    a.reset_parameters(torch.Generator().manual_seed(0))
    b.reset_parameters(torch.Generator().manual_seed(1))
    want = [0.25 * x + 0.75 * y for x, y in zip(a.parameters(), b.parameters())]
    polyak_update(0.25, a, b)
    for w, y in zip(want, b.parameters()):
        torch.testing.assert_close(y, w, rtol=0, atol=0)
    opt = make_optimizer("adam", 1e-3)(a.parameters())
    assert isinstance(opt, torch.optim.Adam)
    g = opt.param_groups[0]
    assert (g["betas"], g["eps"], g["amsgrad"]) == ((0.9, 0.999), 1e-8, False)
    with pytest.raises(ValueError):
        make_optimizer("lion")
    assert dataclasses.is_dataclass(DQNConfig)
