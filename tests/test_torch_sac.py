"""Port's SAC (and its critic ensemble) vs the JAX package's.

Parameters are carried across by ``convert.sac_state`` (the stacked critic
params keep their leading ``[n]`` axis); the same numpy-seeded batch goes
through both updates, and the two standard-normal draws of each JAX update
(next action, actor action) are recomputed from its key and injected.
Float32; losses, ``td_err``, α and the new parameters of every network
agree to rtol 1e-4 / atol 1e-5 after one and after three updates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from border_tpu.agents import SAC as JaxSAC
from border_tpu.agents import SACConfig as JaxSACConfig
from border_tpu.core import spaces as jspaces
from border_tpu.models import mlp as jmlp
from border_tpu.replay.buffer import TransitionBatch as JaxBatch
from border_tpu_torch import convert
from border_tpu_torch.agents import SAC, SACConfig
from border_tpu_torch.core import spaces
from border_tpu_torch.models import EnsembleMLP
from border_tpu_torch.replay import TransitionBatch

B, OBS = 32, 5
LOW, HIGH = np.array([-2.0, -1.0], np.float32), np.array([2.0, 3.0], np.float32)
TOL = dict(rtol=1e-4, atol=1e-5)


def _spaces():
    return (jspaces.Box(-np.inf, np.inf, (OBS,), jnp.float32),
            jspaces.Box(LOW, HIGH, (2,), jnp.float32),
            spaces.Box(-np.inf, np.inf, (OBS,), torch.float32),
            spaces.Box(LOW, HIGH, (2,), torch.float32))


def _batch(seed, weighted=False):
    rng = np.random.default_rng(seed)
    b = dict(
        obs=rng.normal(size=(B, OBS)).astype(np.float32),
        act=rng.uniform(LOW, HIGH, (B, 2)).astype(np.float32),
        next_obs=rng.normal(size=(B, OBS)).astype(np.float32),
        reward=rng.normal(size=B).astype(np.float32),
        terminated=rng.random(B) < 0.25,
        truncated=np.zeros(B, bool),
    )
    w = rng.uniform(0.2, 1.0, B).astype(np.float32) if weighted else None
    return b, w


def _jax_batch(b, w):
    return JaxBatch(**{k: jnp.asarray(v) for k, v in b.items()},
                    weight=jnp.ones(B) if w is None else jnp.asarray(w),
                    ix_sample=jnp.arange(B))


def _torch_batch(b, w):
    return TransitionBatch(**{k: torch.from_numpy(v) for k, v in b.items()},
                           weight=None if w is None else torch.from_numpy(w))


def _noise(key):
    """The two normal draws of a JAX SAC update with ``key``."""
    k_next, k_actor = jax.random.split(key)
    return tuple(torch.from_numpy(np.array(jax.random.normal(k, (B, 2))))
                 for k in (k_next, k_actor))


def _flat(params):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}


def _assert_state_close(tagent, tst, jst):
    for name in ("actor_params", "critic_params", "critic_target_params"):
        net = getattr(tst, name)
        want = convert.net_state_dict(net, getattr(jst, name))
        got = net.state_dict()
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       err_msg=f"{name}.{k}", **TOL)
    np.testing.assert_allclose(tst.log_alpha.item(), float(jst.log_alpha), **TOL)
    assert tst.n_opts == int(jst.n_opts)


@pytest.mark.parametrize("mode, weighted", [("auto", False), ("fix", True)])
def test_updates_match_jax(mode, weighted):
    jos, jas, tos, tas = _spaces()
    kw = dict(actor_hidden=(16, 12), critic_hidden=(16, 12), n_critics=3,
              ent_coef_mode=mode, ent_coef_init=0.5, reward_scale=2.0,
              actor_lr=1e-3, critic_lr=1e-3, ent_lr=1e-2)
    jagent, tagent = JaxSAC(JaxSACConfig(**kw)), SAC(SACConfig(**kw))
    jst = jagent.init(jax.random.PRNGKey(0), jos, jas)
    tst = convert.sac_state(tagent, jst, tos, tas, device="cpu")
    np.testing.assert_allclose(tagent.act_scale.numpy(), np.asarray(jagent.act_scale))
    np.testing.assert_allclose(tagent.act_bias.numpy(), np.asarray(jagent.act_bias))
    assert tagent.target_entropy == jagent.target_entropy == -2.0
    update = jax.jit(jagent.update)
    for i in range(3):
        b, w = _batch(i, weighted)
        key = jax.random.PRNGKey(100 + i)
        jst, wm, wtd = update(jst, _jax_batch(b, w), key)
        tst, gm, gtd = tagent.update(tst, _torch_batch(b, w), noise=_noise(key))
        assert wm.keys() == gm.keys()
        for k in wm:
            np.testing.assert_allclose(float(gm[k]), float(wm[k]), err_msg=k, **TOL)
        np.testing.assert_allclose(gtd.numpy(), np.asarray(wtd), **TOL)
        if i in (0, 2):
            _assert_state_close(tagent, tst, jst)
    if mode == "fix":
        assert float(gm["ent_coef"]) == 0.5 and float(gm["loss_alpha"]) == 0.0
    else:
        assert float(gm["ent_coef"]) != 0.5


def test_actions_within_bounds_and_eval_matches_jax():
    jos, jas, tos, tas = _spaces()
    kw = dict(actor_hidden=(16,), critic_hidden=(16,))
    jagent, tagent = JaxSAC(JaxSACConfig(**kw)), SAC(SACConfig(**kw))
    jst = jagent.init(jax.random.PRNGKey(1), jos, jas)
    tst = convert.sac_state(tagent, jst, tos, tas, device="cpu")
    obs = np.random.default_rng(0).normal(size=(256, OBS)).astype(np.float32) * 5
    want = jagent.select_action_eval(jst, jnp.asarray(obs), None)
    got = tagent.select_action_eval(tst, torch.from_numpy(obs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    a = tagent.select_action(tst, torch.from_numpy(obs), torch.Generator().manual_seed(0))
    for x in (a, got):
        assert x.shape == (256, 2)
        assert (x >= torch.from_numpy(LOW)).all() and (x <= torch.from_numpy(HIGH)).all()
    # the draw is the generator's: the same seed, the same actions
    a2 = tagent.select_action(tst, torch.from_numpy(obs), torch.Generator().manual_seed(0))
    assert torch.equal(a, a2)


def test_ensemble_forward_matches_vmapped_flax():
    """EnsembleMLP against ``jax.vmap`` over stacked flax MLP params."""
    net = jmlp.MLP(out_dim=1, hidden=(12, 7))
    x = np.random.default_rng(0).normal(size=(B, OBS + 2)).astype(np.float32)
    params = jax.vmap(lambda k: net.init(k, jnp.asarray(x)))(
        jax.random.split(jax.random.PRNGKey(0), 4))
    params = jax.tree.map(lambda p: p + 0.01 * jnp.arange(p.size).reshape(p.shape)
                          / p.size if p.ndim == 2 else p, params)  # non-zero biases
    want = jax.vmap(lambda p: net.apply(p, jnp.asarray(x)))(params)
    ens = EnsembleMLP(4, OBS + 2, 1, (12, 7))
    ens.load_state_dict(convert.ensemble_state_dict(ens, params))
    got = ens(torch.from_numpy(x))
    assert got.shape == (4, B, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    # the flax Dense initialisation: zero biases, lecun-normal weights
    ens.reset_parameters(torch.Generator().manual_seed(0))
    assert all((b == 0).all() for b in ens.biases)
    w = ens.weights[0]
    assert abs(w.std().item() - (1 / (OBS + 2)) ** 0.5) < 0.1


def test_converter_requires_fresh_optimizers():
    jos, jas, tos, tas = _spaces()
    kw = dict(actor_hidden=(8,), critic_hidden=(8,))
    jagent, tagent = JaxSAC(JaxSACConfig(**kw)), SAC(SACConfig(**kw))
    jst = jagent.init(jax.random.PRNGKey(2), jos, jas)
    b, w = _batch(0)
    jst, _, _ = jagent.update(jst, _jax_batch(b, w), jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="fresh"):
        convert.sac_state(tagent, jst, tos, tas, device="cpu")
