"""Port's Reacher, Dict space and dict observations vs the JAX package's.

Identical numpy-seeded states and actions go through ``step_env`` on both
sides (the JAX side under ``vmap``) over rollouts; the reset's uniform
draws are recomputed from the JAX keys and injected.  Floats are held to
rtol 1e-6 / atol 1e-6: the distance is a norm, and ``vector_norm`` need not
round as XLA does.  Dict observations go through ``VecEnv`` and the flat
``ReplayBuffer`` as in ``tests/test_reacher.py``, and the same pushes and
indices give the JAX buffer's batch exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from border_tpu.core import spaces as jspaces
from border_tpu.envs import make as jax_make
from border_tpu.envs import reacher as jreacher
from border_tpu.replay import ReplayBuffer as JaxReplayBuffer
from border_tpu.replay import Transition as JaxTransition
from border_tpu_torch import convert
from border_tpu_torch.core import VecEnv, spaces
from border_tpu_torch.envs import make, reacher
from border_tpu_torch.replay import ReplayBuffer, Transition

N = 64
TOL = dict(rtol=1e-6, atol=1e-6)
KEYS = ("achieved_goal", "desired_goal", "observation")


def _jax_states(seed):
    """A batched JAX state with angles over several turns of both signs (so
    the wrap sees negative values), some instances one step short of the
    time limit."""
    rng = np.random.default_rng(seed)
    f = lambda *s, lo=-1.0, hi=1.0: jnp.asarray(  # noqa: E731
        rng.uniform(lo, hi, (N, *s)).astype(np.float32))
    t = rng.integers(0, 49, N).astype(np.int32)
    t[: N // 8] = 49
    return jreacher.ReacherState(q=f(2, lo=-9.0, hi=9.0), qd=f(2, lo=-8.0, hi=8.0),
                                 goal=f(2, lo=-0.85, hi=0.85), t=jnp.asarray(t))


def _actions(seed, steps):
    rng = np.random.default_rng(seed + 100)
    return rng.uniform(-1.5, 1.5, (steps, N, 2)).astype(np.float32)


def _assert_obs_close(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_step_env_matches_jax_over_a_rollout(seed):
    jenv, env = jax_make("Reacher-v0"), make("Reacher-v0")
    jp, p = jenv.default_params, env.default_params
    jst = _jax_states(seed)
    st = convert.reacher_state(jst, device="cpu")
    assert isinstance(st, reacher.ReacherState)
    assert (np.asarray(jst.q) < -2 * np.pi).any()  # negative angles wrap
    step = jax.jit(jax.vmap(jenv.step_env, in_axes=(0, 0, 0, None)),
                   static_argnums=3)
    keys = jax.random.split(jax.random.PRNGKey(seed), N)
    for t, act in enumerate(_actions(seed, 12)):
        wobs, jst, wr, wterm, wtrunc, _ = step(keys, jst, jnp.asarray(act), jp)
        gobs, st, gr, gterm, gtrunc, info = env.step_env(
            None, st, torch.from_numpy(act), p)
        assert info == {}
        _assert_obs_close(gobs, wobs)
        np.testing.assert_allclose(gr.numpy(), np.asarray(wr), err_msg=str(t), **TOL)
        np.testing.assert_array_equal(gterm.numpy(), np.asarray(wterm))
        np.testing.assert_array_equal(gtrunc.numpy(), np.asarray(wtrunc))
        np.testing.assert_array_equal(st.t.numpy(), np.asarray(jst.t))
        # the wrap keeps the angles in [-π, π)
        assert (st.q.abs() <= np.pi + 1e-6).all()
        np.testing.assert_allclose(st.q.numpy(), np.asarray(jst.q), **TOL)
        np.testing.assert_allclose(st.qd.numpy(), np.asarray(jst.qd), **TOL)
    assert gtrunc.any() and not gterm.any()


def test_success_bonus_matches_jax():
    """An arm already at its goal earns the +1 bonus on both sides."""
    jenv, env = jax_make("Reacher-v0"), make("Reacher-v0")
    jst = _jax_states(3)
    fk = np.asarray(jax.vmap(jreacher._fk)(jst.q))
    jst = jst.replace(qd=jnp.zeros_like(jst.qd), goal=jnp.asarray(fk))
    act = np.zeros((N, 2), np.float32)
    _, _, wr, *_ = jax.vmap(jenv.step_env, in_axes=(0, 0, 0, None))(
        jax.random.split(jax.random.PRNGKey(0), N), jst, jnp.asarray(act),
        jenv.default_params)
    _, _, gr, *_ = env.step_env(None, convert.reacher_state(jst, device="cpu"),
                                torch.from_numpy(act), env.default_params)
    assert (np.asarray(wr) > 0.9).all()
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), **TOL)


def _reset_draws(keys):
    """The uniforms the JAX reset draws from each key, as [N, 4]."""
    def one(key):
        k1, k2, k3 = jax.random.split(key, 3)
        return jnp.concatenate([jax.random.uniform(k1, (2,)),
                                jax.random.uniform(k2, (1,)),
                                jax.random.uniform(k3, (1,))])
    return torch.from_numpy(np.array(jax.vmap(one)(keys)))


@pytest.mark.parametrize("env_id", ["Reacher-v0", "ReacherFlat-v0", "ReacherGoal-v0"])
def test_reset_with_injected_draws_matches_jax(env_id):
    jenv, env = jax_make(env_id), make(env_id)
    keys = jax.random.split(jax.random.PRNGKey(7), N)
    wobs, wst = jax.vmap(jenv.reset_env, in_axes=(0, None))(keys, jenv.default_params)
    gobs, gst = env.reset_env(None, N, env.default_params, torch.device("cpu"),
                              u=_reset_draws(keys))
    if isinstance(wobs, dict):
        _assert_obs_close(gobs, wobs)
    else:
        np.testing.assert_allclose(gobs.numpy(), np.asarray(wobs), **TOL)
    for name in ("q", "qd", "goal"):
        np.testing.assert_allclose(getattr(gst, name).numpy(),
                                   np.asarray(getattr(wst, name)), **TOL)
    np.testing.assert_array_equal(gst.t.numpy(), np.asarray(wst.t))
    # goals lie in the reachable annulus
    r = gst.goal.norm(dim=1)
    assert ((r > 0.15 - 1e-6) & (r < 0.85 + 1e-6)).all()


@pytest.mark.parametrize("keys", [None, ("observation", "desired_goal"),
                                  ("desired_goal", "observation", "achieved_goal")])
def test_flatten_wrapper_key_orders_match_jax(keys):
    jenv = jreacher.FlattenDictWrapper(jreacher.Reacher(), keys=keys)
    env = reacher.FlattenDictWrapper(reacher.Reacher(), keys=keys)
    jst = _jax_states(5)
    act = _actions(5, 1)[0]
    wobs, *_ = jax.vmap(jenv.step_env, in_axes=(0, 0, 0, None))(
        jax.random.split(jax.random.PRNGKey(0), N), jst, jnp.asarray(act),
        jenv.default_params)
    gobs, *_ = env.step_env(None, convert.reacher_state(jst, device="cpu"),
                            torch.from_numpy(act), env.default_params)
    dim = {None: 8, 2: 6, 3: 8}[None if keys is None else len(keys)]
    assert env.observation_space(None).shape == (dim,)
    assert jenv.observation_space(jenv.default_params).shape == (dim,)
    np.testing.assert_allclose(gobs.numpy(), np.asarray(wobs), **TOL)
    if keys is None:  # the Dict space's sorted order
        assert env._keys(None) == list(KEYS)


def test_dict_space_sorts_its_keys_like_jax():
    box = lambda n: spaces.Box(-1.0, 1.0, (n,), torch.float32)  # noqa: E731
    d = spaces.Dict({"observation": box(4), "desired_goal": box(2),
                     "achieved_goal": box(2)})
    jd = jax_make("Reacher-v0").observation_space(None)
    assert [k for k, _ in d.spaces] == [k for k, _ in jd.spaces] == list(KEYS)
    assert d.flat_dim == jd.flat_dim == 8
    assert d.shape == {"achieved_goal": (2,), "desired_goal": (2,),
                       "observation": (4,)}
    z = d.zero("cpu")
    assert list(z) == list(KEYS) and z["observation"].shape == (4,)
    assert d.contains({k: np.zeros(s) for k, s in d.shape.items()})
    assert not d.contains({"observation": np.zeros(4)})
    assert isinstance(jd, jspaces.Dict) and d == spaces.Dict(dict(d.spaces))


def test_dict_obs_shapes():
    """≙ tests/test_reacher.py::test_dict_obs_shapes."""
    env = make("Reacher-v0")
    p = env.default_params
    obs, state = env.reset_env(torch.Generator().manual_seed(0), 1, p, "cpu")
    assert set(obs) == set(KEYS)
    assert obs["observation"].shape == (1, 4) and obs["desired_goal"].shape == (1, 2)
    act = torch.rand((1, 2)) * 2 - 1
    _, _, r, *_ = env.step_env(None, state, act, p)
    assert float(r) <= 1.0


def _example(vec):
    obs0 = vec.observation_space.zero("cpu")
    flag = torch.zeros((), dtype=torch.bool)
    return Transition(obs=obs0, act=vec.action_space.zero("cpu"), next_obs=obs0,
                      reward=torch.zeros(()), terminated=flag, truncated=flag)


def test_dict_obs_through_vec_env_and_replay():
    """≙ tests/test_reacher.py::test_dict_obs_through_vec_env_and_replay,
    over an auto-reset: 60 steps of 50-step episodes."""
    vec = VecEnv(make("Reacher-v0"), 4, device="cpu")
    state = vec.reset(0)
    assert isinstance(state.obs, dict)
    buf = ReplayBuffer(capacity=64, device="cpu")
    bstate = buf.init(_example(vec))
    assert bstate.data.obs["observation"].shape == (64, 4)
    gen = torch.Generator().manual_seed(1)
    for t in range(60):
        acts = torch.rand((4, 2), generator=gen) * 2 - 1
        prev_obs, prev_len = state.obs, state.episode_length
        ts, state = vec.step(state, acts)
        bstate = buf.process_step(bstate, prev_obs, acts, ts, prev_len)
        if t == 49:  # the episodes end together: obs is a fresh reset
            assert ts.truncated.all()
            assert not torch.equal(ts.obs["desired_goal"], ts.final_obs["desired_goal"])
            assert torch.equal(ts.final_obs["desired_goal"], prev_obs["desired_goal"])
            assert (state.episode_length == 0).all() and (state.last_length == 50).all()
    assert (bstate.size, bstate.cursor) == (64, 240 % 64)
    batch = buf.sample(bstate, gen, 8)
    assert batch.obs["observation"].shape == (8, 4)
    assert batch.next_obs["desired_goal"].shape == (8, 2)


@pytest.mark.parametrize("n_step", [1, 3])
def test_dict_obs_buffer_matches_jax(n_step):
    """The same dict-observation pushes into the JAX buffer and the port's;
    the same storage indices give the same batch (n-step windows too)."""
    rng = np.random.default_rng(0)
    cap, n = 32, 4
    jbuf = JaxReplayBuffer(cap, n_step=n_step, stride=n)
    buf = ReplayBuffer(cap, n_step=n_step, stride=n, device="cpu")
    zero = lambda s: {k: np.zeros(v, np.float32) for k, v in  # noqa: E731
                      (("achieved_goal", 2), ("desired_goal", 2), ("observation", 4))}
    jst = jbuf.init(JaxTransition(obs=zero(()), act=np.zeros(2, np.float32),
                                  next_obs=zero(()), reward=np.float32(0),
                                  terminated=np.bool_(False), truncated=np.bool_(False)))
    vec = VecEnv(make("Reacher-v0"), n, device="cpu")
    st = buf.init(_example(vec))
    for _ in range(11):  # wraps the ring
        obs = {k: rng.normal(size=(n, d)).astype(np.float32)
               for k, d in (("achieved_goal", 2), ("desired_goal", 2), ("observation", 4))}
        nobs = {k: v + 1 for k, v in obs.items()}
        tr = dict(act=rng.normal(size=(n, 2)).astype(np.float32),
                  reward=rng.normal(size=n).astype(np.float32),
                  terminated=rng.random(n) < 0.2, truncated=rng.random(n) < 0.1)
        jst = jbuf.push(jst, JaxTransition(obs=obs, next_obs=nobs, **tr))
        st = buf.push(st, Transition(
            obs={k: torch.from_numpy(v) for k, v in obs.items()},
            next_obs={k: torch.from_numpy(v) for k, v in nobs.items()},
            **{k: torch.from_numpy(v) for k, v in tr.items()}))
    assert (st.cursor, st.size) == (int(jst.cursor), int(jst.size))
    idx = rng.integers(0, cap, 16).astype(np.int32)
    picked = jax.tree.map(lambda s: s[idx], jst.data)
    if n_step > 1:
        want = jbuf._nstep_batch(jst, jnp.asarray(idx), picked, jnp.ones(16))
    else:
        want = picked
    got = buf.sample_at(st, torch.from_numpy(idx).long())
    for name in ("obs", "next_obs"):
        _assert_obs_close(getattr(got, name), getattr(want, name))
    for name in ("act", "reward", "terminated", "truncated"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    # the converter carries the JAX buffer state, dict observations and all
    cst = convert.replay_state(jst, device="cpu")
    for k in KEYS:
        assert torch.equal(cst.data.obs[k], st.data.obs[k])
