"""Port's offline agents (BC, AWAC, IQL) vs the JAX package's.

Parameters are carried across by ``convert.bc_state`` / ``awac_state`` /
``iql_state``; the same numpy-seeded batches go through both updates, and
AWAC's two normal draws an update are recomputed from the JAX key and
injected.  Float32; losses, ``td_err`` and every network's new parameters
agree to rtol 1e-4 / atol 1e-5 over several updates.  BC runs with a cosine
learning-rate schedule, past its horizon, where both stop moving.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from border_tpu.agents import AWAC as JaxAWAC
from border_tpu.agents import BC as JaxBC
from border_tpu.agents import IQL as JaxIQL
from border_tpu.agents import AWACConfig as JaxAWACConfig
from border_tpu.agents import BCConfig as JaxBCConfig
from border_tpu.agents import IQLConfig as JaxIQLConfig
from border_tpu.core import spaces as jspaces
from border_tpu.replay.buffer import TransitionBatch as JaxBatch
from border_tpu_torch import convert
from border_tpu_torch.agents import AWAC, BC, IQL, AWACConfig, BCConfig, IQLConfig
from border_tpu_torch.agents.common import cosine_decay_schedule, lr_at
from border_tpu_torch.core import spaces
from border_tpu_torch.replay import TransitionBatch

B, OBS, ACT = 32, 6, 2
TOL = dict(rtol=1e-4, atol=1e-5)
UPDATES = 4


def _spaces(discrete=False):
    jact = jspaces.Discrete(4) if discrete else jspaces.Box(-1.0, 1.0, (ACT,), jnp.float32)
    tact = spaces.Discrete(4) if discrete else spaces.Box(-1.0, 1.0, (ACT,), torch.float32)
    return (jspaces.Box(-np.inf, np.inf, (OBS,), jnp.float32), jact,
            spaces.Box(-np.inf, np.inf, (OBS,), torch.float32), tact)


def _batch(seed, discrete=False, weighted=False):
    rng = np.random.default_rng(seed)
    act = (rng.integers(0, 4, B).astype(np.int32) if discrete
           else rng.uniform(-1, 1, (B, ACT)).astype(np.float32))
    b = dict(
        obs=rng.normal(size=(B, OBS)).astype(np.float32),
        act=act,
        next_obs=rng.normal(size=(B, OBS)).astype(np.float32),
        reward=rng.normal(size=B).astype(np.float32),
        terminated=rng.random(B) < 0.25,
        truncated=rng.random(B) < 0.1,
    )
    w = rng.uniform(0.2, 1.0, B).astype(np.float32) if weighted else None
    return (JaxBatch(**{k: jnp.asarray(v) for k, v in b.items()},
                     weight=jnp.ones(B) if w is None else jnp.asarray(w),
                     ix_sample=jnp.arange(B)),
            TransitionBatch(**{k: torch.from_numpy(v) for k, v in b.items()},
                            weight=None if w is None else torch.from_numpy(w)))


def _noise(key):
    """AWAC's two normal draws (next action, policy action) from ``key``."""
    return tuple(torch.from_numpy(np.array(jax.random.normal(k, (B, ACT))))
                 for k in jax.random.split(key))


def _assert_nets_close(tst, jst, names):
    for name in names:
        net = getattr(tst, name)
        want = convert.net_state_dict(net, getattr(jst, name))
        got = net.state_dict()
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       err_msg=f"{name}.{k}", **TOL)
    assert tst.n_opts == int(jst.n_opts)


def _run(jagent, tagent, jst, tst, names, discrete=False, weighted=False,
         inject=False):
    update = jax.jit(jagent.update)
    for i in range(UPDATES):
        jb, tb = _batch(i, discrete, weighted)
        key = jax.random.PRNGKey(50 + i)
        jst, wm, wtd = update(jst, jb, key)
        tst, gm, gtd = tagent.update(tst, tb, **(
            {"noise": _noise(key)} if inject else {}))
        assert wm.keys() == gm.keys()
        for k in wm:
            np.testing.assert_allclose(float(gm[k]), float(wm[k]), err_msg=k, **TOL)
        if wtd is None:
            assert gtd is None
        else:
            np.testing.assert_allclose(gtd.numpy(), np.asarray(wtd), **TOL)
    _assert_nets_close(tst, jst, names)
    return jst, tst


@pytest.mark.parametrize("discrete", [False, True])
def test_bc_with_cosine_schedule_matches_jax(discrete):
    jos, jas, tos, tas = _spaces(discrete)
    horizon = UPDATES - 1  # the last update runs at lr 0
    mode = "discrete" if discrete else "continuous"
    jagent = JaxBC(JaxBCConfig(action_mode=mode, hidden=(16, 16),
                               lr=optax.cosine_decay_schedule(1e-2, horizon)))
    tagent = BC(BCConfig(action_mode=mode, hidden=(16, 16),
                         lr=cosine_decay_schedule(1e-2, horizon)))
    jst = jagent.init(jax.random.PRNGKey(0), jos, jas)
    tst = convert.bc_state(tagent, jst, tos, tas, device="cpu")
    before = {k: v.clone() for k, v in tst.params.state_dict().items()}
    jst, tst = _run(jagent, tagent, jst, tst, ("params",), discrete=discrete)
    assert any(not torch.equal(v, tst.params.state_dict()[k]) for k, v in before.items())
    # past the horizon the rate is 0 on both sides: a further update moves
    # nothing (Adam's step is lr·m̂/(√v̂+ε))
    jb, tb = _batch(9, discrete)
    tst_before = {k: v.clone() for k, v in tst.params.state_dict().items()}
    tagent.update(tst, tb)
    for k, v in tst.params.state_dict().items():
        assert torch.equal(v, tst_before[k]), k
    obs = torch.from_numpy(np.random.default_rng(3).normal(size=(8, OBS)).astype(np.float32))
    want = jagent.select_action(jst, jnp.asarray(obs.numpy()), None)
    got = tagent.select_action(tst, obs)
    if discrete:
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cosine_schedule_matches_optax():
    for init, steps in ((1e-3, 12_000), (3e-4, 7), (1.0, 1)):
        want = optax.cosine_decay_schedule(init, steps)
        got = cosine_decay_schedule(init, steps)
        for k in sorted({0, 1, steps // 3, steps // 2, steps - 1, steps, steps + 5}):
            np.testing.assert_allclose(got(k), float(want(jnp.int32(k))),
                                       rtol=1e-6, atol=1e-12)
    assert lr_at(3e-4, 99) == 3e-4 and lr_at(cosine_decay_schedule(2.0, 4), 4) == 0.0


@pytest.mark.parametrize("weight_mode, limit, weighted", [
    ("exp", "clamp", False), ("softmax", "clamp", True), ("exp", "tanh", False)])
def test_awac_matches_jax(weight_mode, limit, weighted):
    jos, jas, tos, tas = _spaces()
    kw = dict(actor_hidden=(16, 12), critic_hidden=(16, 12), lambda_=0.5,
              exp_adv_max=3.0, weight_mode=weight_mode, action_limit=limit,
              actor_lr=1e-3, critic_lr=1e-3)
    jagent, tagent = JaxAWAC(JaxAWACConfig(**kw)), AWAC(AWACConfig(**kw))
    jst = jagent.init(jax.random.PRNGKey(1), jos, jas)
    tst = convert.awac_state(tagent, jst, tos, tas, device="cpu")
    names = ("actor_params", "critic_params", "critic_target_params")
    jst, tst = _run(jagent, tagent, jst, tst, names, weighted=weighted, inject=True)
    obs = np.random.default_rng(4).normal(size=(16, OBS)).astype(np.float32) * 4
    want = jagent.select_action_eval(jst, jnp.asarray(obs), None)
    got = tagent.select_action_eval(tst, torch.from_numpy(obs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    a = tagent.select_action(tst, torch.from_numpy(obs), torch.Generator().manual_seed(0))
    assert a.shape == (16, ACT) and (a.abs() <= 1).all()


@pytest.mark.parametrize("weighted", [False, True])
def test_iql_matches_jax(weighted):
    jos, jas, tos, tas = _spaces()
    kw = dict(actor_hidden=(16, 12), critic_hidden=(16, 12), value_hidden=(12,),
              exp_adv_max=5.0, actor_lr=1e-3, critic_lr=1e-3, value_lr=1e-3)
    jagent, tagent = JaxIQL(JaxIQLConfig(**kw)), IQL(IQLConfig(**kw))
    jst = jagent.init(jax.random.PRNGKey(2), jos, jas)
    tst = convert.iql_state(tagent, jst, tos, tas, device="cpu")
    names = ("actor_params", "critic_params", "critic_target_params", "value_params")
    _run(jagent, tagent, jst, tst, names, weighted=weighted)


def test_converters_require_fresh_optimizers():
    jos, jas, tos, tas = _spaces()
    jagent = JaxIQL(JaxIQLConfig(actor_hidden=(8,), critic_hidden=(8,),
                                 value_hidden=(8,)))
    jst = jagent.init(jax.random.PRNGKey(3), jos, jas)
    jst, _, _ = jagent.update(jst, _batch(0)[0], None)
    with pytest.raises(ValueError, match="fresh"):
        convert.iql_state(IQL(IQLConfig(actor_hidden=(8,), critic_hidden=(8,),
                                        value_hidden=(8,))), jst, tos, tas,
                          device="cpu")
