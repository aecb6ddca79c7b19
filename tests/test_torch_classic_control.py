"""Port's classic-control envs vs the JAX package's.

Identical numpy-seeded states and actions go through ``step_env`` on both
sides (the JAX side under ``vmap``).  XLA on the CPU may contract
multiply-adds, so floats are held to rtol 1e-6 / atol 1e-6 and not bitwise;
flags and the step counter are compared exactly, on states kept away from
the thresholds by more than the tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from border_tpu.core.env import VecEnv as JaxVecEnv
from border_tpu.envs import classic_control as jcc
from border_tpu.envs import make as jax_make
from border_tpu_torch import convert
from border_tpu_torch.core.env import VecEnv
from border_tpu_torch.envs import classic_control as cc
from border_tpu_torch.envs import make

N = 64
TOL = dict(rtol=1e-6, atol=1e-6)
IDS = ["CartPole-v1", "Pendulum-v1", "MountainCar-v0",
       "MountainCarContinuous-v0", "Acrobot-v1"]


def _states(env_id, seed):
    """A batched JAX state spanning the env's reachable range, with some
    instances one step short of the time limit."""
    rng = np.random.default_rng(seed)
    f = lambda lo, hi: jnp.asarray(rng.uniform(lo, hi, N).astype(np.float32))  # noqa: E731
    limit = jax_make(env_id).default_params.max_steps
    t = rng.integers(0, limit - 1, N)
    t[: N // 8] = limit - 1
    t = jnp.asarray(t.astype(np.int32))
    if env_id == "CartPole-v1":
        return jcc.CartPoleState(f(-2.5, 2.5), f(-2, 2), f(-0.25, 0.25), f(-2, 2), t)
    if env_id == "Pendulum-v1":
        return jcc.PendulumState(f(-7, 7), f(-8, 8), t)
    if env_id.startswith("MountainCar"):
        return jcc.MountainCarState(f(-1.2, 0.6), f(-0.07, 0.07), t)
    return jcc.AcrobotState(f(-3.1, 3.1), f(-3.1, 3.1), f(-4, 4), f(-9, 9), t)


def _actions(env, seed):
    rng = np.random.default_rng(seed + 100)
    space = env.action_space(env.default_params)
    if hasattr(space, "n"):
        return rng.integers(0, space.n, N, dtype=np.int32)
    return rng.uniform(-2.5, 2.5, (N, 1)).astype(np.float32)


def _assert_state_close(got, want):
    for name in type(want).__dataclass_fields__:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if name == "t":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **TOL)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("env_id", IDS)
def test_step_env_matches_jax(env_id, seed):
    jenv, env = jax_make(env_id), make(env_id)
    jst = _states(env_id, seed)
    act = _actions(jenv, seed)
    keys = jax.random.split(jax.random.PRNGKey(seed), N)
    wobs, wst, wr, wterm, wtrunc, _ = jax.vmap(
        jenv.step_env, in_axes=(0, 0, 0, None)
    )(keys, jst, jnp.asarray(act), jenv.default_params)
    tst = convert.env_state(jst, device="cpu")
    assert type(tst).__name__ == type(jst).__name__
    gobs, gst, gr, gterm, gtrunc, info = env.step_env(
        None, tst, torch.from_numpy(act), env.default_params)

    assert info == {} and gobs.dtype == torch.float32 and gr.dtype == torch.float32
    np.testing.assert_allclose(gobs.numpy(), np.asarray(wobs), **TOL)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), **TOL)
    _assert_state_close(gst, wst)
    np.testing.assert_array_equal(gterm.numpy(), np.asarray(wterm))
    np.testing.assert_array_equal(gtrunc.numpy(), np.asarray(wtrunc))
    # the time limit was reached by some instances: truncated unless the
    # same step terminated
    at_limit = np.asarray(jst.t) == jenv.default_params.max_steps - 1
    np.testing.assert_array_equal(gtrunc.numpy(),
                                  at_limit & ~np.asarray(wterm))
    assert at_limit.any()


@pytest.mark.parametrize("env_id", IDS)
def test_rollout_stays_close_to_jax_over_30_steps(env_id):
    """30 steps from the same state with the same actions: the float
    differences of one step do not grow past 1e-4.  Acrobot is a double
    pendulum, which doubles a difference every few steps: 6 steps there."""
    n_steps = 6 if env_id == "Acrobot-v1" else 30
    jenv, env = jax_make(env_id), make(env_id)
    jst = _states(env_id, 7).replace(t=jnp.zeros((N,), jnp.int32))
    tst = convert.env_state(jst, device="cpu")
    step = jax.jit(jax.vmap(jenv.step_env, in_axes=(0, 0, 0, None)))
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    for i in range(n_steps):
        act = _actions(jenv, i)
        wobs, jst, wr, wterm, _, _ = step(keys, jst, jnp.asarray(act),
                                          jenv.default_params)
        gobs, tst, gr, gterm, _, _ = env.step_env(
            None, tst, torch.from_numpy(act), env.default_params)
    np.testing.assert_allclose(gobs.numpy(), np.asarray(wobs), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("env_id", IDS)
def test_spaces_and_reset_ranges(env_id):
    jenv, env = jax_make(env_id), make(env_id)
    jp, p = jenv.default_params, env.default_params
    assert p.max_steps == jp.max_steps
    for fn in ("observation_space", "action_space"):
        jspace, space = getattr(jenv, fn)(jp), getattr(env, fn)(p)
        assert type(space).__name__ == type(jspace).__name__
        assert tuple(space.shape) == tuple(jspace.shape)
        if hasattr(space, "n"):
            assert space.n == jspace.n
        else:
            np.testing.assert_allclose(np.asarray(space.low, np.float32),
                                       np.asarray(jspace.low))
            np.testing.assert_allclose(np.asarray(space.high, np.float32),
                                       np.asarray(jspace.high))
    n = 4096
    obs, st = env.reset_env(torch.Generator().manual_seed(0), n, p,
                            torch.device("cpu"))
    jobs, jst = jax.vmap(jenv.reset_env, in_axes=(0, None))(
        jax.random.split(jax.random.PRNGKey(0), n), jp)
    assert tuple(obs.shape) == tuple(jobs.shape) and (st.t == 0).all()
    for name in type(jst).__dataclass_fields__:
        g, w = getattr(st, name).float(), np.asarray(getattr(jst, name), np.float32)
        # the same range and spread as the JAX reset's draws
        assert g.min().item() >= w.min() - 0.02 * (np.ptp(w) + 1e-9), name
        assert g.max().item() <= w.max() + 0.02 * (np.ptp(w) + 1e-9), name
        np.testing.assert_allclose(g.std().item(), w.std(), rtol=0.05, atol=1e-9,
                                   err_msg=name)


def test_vec_env_auto_reset_matches_jax_bookkeeping():
    """CartPole instances past the angle threshold terminate and reset; the
    episode bookkeeping agrees with the JAX VecEnv's."""
    jenv = jax_make("CartPole-v1")
    jst = _states("CartPole-v1", 3)
    jvec = JaxVecEnv(jenv, N)
    rng = np.random.default_rng(3)
    jvs = jvec.reset(jax.random.PRNGKey(0)).replace(
        env_state=jst, obs=jax.vmap(jenv._obs)(jst),
        episode_return=jnp.asarray(rng.integers(0, 50, N).astype(np.float32)),
        episode_length=jnp.asarray(rng.integers(0, 50, N, dtype=np.int32)),
    )
    act = jnp.asarray(rng.integers(0, 2, N, dtype=np.int32))
    wts, wvs = jvec.step(jvs, act)
    vec = VecEnv(make("CartPole-v1"), N, device="cpu")
    tvs = convert.vec_env_state(jvs, seed_or_gen=0, device="cpu")
    gts, gvs = vec.step(tvs, torch.from_numpy(np.array(act)))
    done = np.asarray(wts.done)
    assert done.any() and not done.all()
    np.testing.assert_array_equal(gts.done.numpy(), done)
    np.testing.assert_allclose(gts.final_obs.numpy(), np.asarray(wts.final_obs), **TOL)
    for name in ("episode_return", "episode_length", "last_return", "last_length"):
        np.testing.assert_array_equal(getattr(gvs, name).numpy(),
                                      np.asarray(getattr(wvs, name)), err_msg=name)
    np.testing.assert_allclose(gvs.obs.numpy()[~done], np.asarray(wvs.obs)[~done], **TOL)
    reset = torch.from_numpy(done.copy())
    assert (gvs.obs[reset].abs() <= 0.05).all()
    assert (gvs.env_state.t[reset] == 0).all()
    assert isinstance(gvs.env_state, cc.CartPoleState)
