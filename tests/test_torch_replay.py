"""Port's flat ``ReplayBuffer`` vs the JAX package's.

Identical numpy-seeded transitions are pushed into both buffers; the JAX
sample's own draws (recomputed from its key) are injected into the port's
``draw`` / ``draw_per``.  Everything is compared bitwise except the n-step
reward sum and discount and the PER weights, where the two frameworks'
``pow`` may round another way (rtol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from border_tpu.replay import buffer as jbuffer
from border_tpu_torch import convert
from border_tpu_torch.replay import (
    PerConfig,
    ReplayBuffer,
    ReplayBufferState,
    Transition,
)

CAP, N_ENVS, OBS = 64, 4, 3
POW_RTOL = 1e-6


def _transitions(seed, n=N_ENVS, p_done=0.15):
    rng = np.random.default_rng(seed)
    return dict(
        obs=rng.normal(size=(n, OBS)).astype(np.float32),
        act=rng.integers(0, 5, n, dtype=np.int32),
        next_obs=rng.normal(size=(n, OBS)).astype(np.float32),
        reward=rng.normal(size=n).astype(np.float32),
        terminated=rng.random(n) < p_done,
        truncated=rng.random(n) < p_done / 3,
    )


def _example(lib):
    if lib == "jax":
        z = jnp.zeros((OBS,), jnp.float32)
        return jbuffer.Transition(z, jnp.int32(0), z, jnp.float32(0),
                                  jnp.bool_(False), jnp.bool_(False))
    z = torch.zeros((OBS,))
    flag = torch.zeros((), dtype=torch.bool)
    return Transition(z, torch.zeros((), dtype=torch.int32), z,
                      torch.zeros(()), flag, flag)


def _pair(pushes, per=False, **kw):
    """Both buffers after the same ``pushes`` pushes of N_ENVS transitions."""
    jper = jbuffer.PerConfig(n_opts_final=1000) if per else None
    tper = PerConfig(n_opts_final=1000) if per else None
    jbuf = jbuffer.ReplayBuffer(CAP, per=jper, **kw)
    tbuf = ReplayBuffer(CAP, per=tper, device="cpu", **kw)
    jst, tst = jbuf.init(_example("jax")), tbuf.init(_example("torch"))
    for i in range(pushes):
        d = _transitions(i)
        jst = jbuf.push(jst, jbuffer.Transition(
            **{k: jnp.asarray(v) for k, v in d.items()}))
        tst = tbuf.push(tst, Transition(
            **{k: torch.from_numpy(v) for k, v in d.items()}))
    return jbuf, jst, tbuf, tst


def _assert_state_equal(tst: ReplayBufferState, jst):
    assert tst.cursor == int(jst.cursor) and tst.size == int(jst.size)
    for name in ("obs", "act", "next_obs", "reward", "terminated", "truncated"):
        got, want = getattr(tst.data, name), getattr(jst.data, name)
        assert str(got.dtype).split(".")[1] == str(want.dtype), name
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    if jst.tree is not None:
        np.testing.assert_array_equal(tst.tree.sum_tree.numpy(),
                                      np.asarray(jst.tree.sum_tree))
        np.testing.assert_array_equal(tst.tree.min_tree.numpy(),
                                      np.asarray(jst.tree.min_tree))


def _assert_batch_equal(got, want, nstep):
    for name in ("obs", "act", "next_obs", "terminated", "truncated",
                 "ix_sample"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            err_msg=name)
    if nstep:
        np.testing.assert_allclose(got.reward.numpy(), np.asarray(want.reward),
                                   rtol=POW_RTOL, atol=1e-7)
        np.testing.assert_allclose(got.discount.numpy(),
                                   np.asarray(want.discount), rtol=POW_RTOL)
    else:
        np.testing.assert_array_equal(got.reward.numpy(), np.asarray(want.reward))
        assert got.discount is None and want.discount is None


@pytest.mark.parametrize("pushes", [3, 16, 21])
@pytest.mark.parametrize("per", [False, True])
def test_push_matches_jax_before_and_after_the_ring_wraps(pushes, per):
    jbuf, jst, tbuf, tst = _pair(pushes, per=per)
    _assert_state_equal(tst, jst)
    assert tbuf.fill(tst) == int(jbuf.fill(jst)) == min(pushes * N_ENVS, CAP)
    # the converter carries the JAX state over to the same thing
    carried = convert.replay_state(jst, device="cpu")
    _assert_state_equal(carried, jst)
    want, got = jbuf.diagnostics(jst), tbuf.diagnostics(tst)
    assert int(got["num_terminated"]) == int(want["num_terminated"])
    np.testing.assert_allclose(float(got["sum_rewards"]),
                               float(want["sum_rewards"]), rtol=1e-5)
    assert got["size"] == int(want["size"])


@pytest.mark.parametrize("pushes", [5, 21])
def test_uniform_sample_with_injected_indices_matches_jax(pushes):
    jbuf, jst, tbuf, tst = _pair(pushes)
    key, b = jax.random.PRNGKey(pushes), 32
    want = jbuf.sample(jst, key, b)
    raw = np.array(jax.random.randint(key, (b,), 0, int(jst.size)))
    got = tbuf.sample_at(tst, tbuf.draw(tst, None, b, raw=torch.from_numpy(raw).long()))
    _assert_batch_equal(got, want, nstep=False)
    assert got.weight is None and (np.asarray(want.weight) == 1).all()
    # the port's own generator draws inside the written region
    idx = tbuf.draw(tst, torch.Generator().manual_seed(0), 4096)
    assert int(idx.min()) == 0 and int(idx.max()) == tst.size - 1
    batch = tbuf.sample(tst, torch.Generator().manual_seed(0), 8)
    assert len(batch) == 8 and batch.ix_sample.dtype == torch.int32


@pytest.mark.parametrize("pushes", [2, 7, 21])
def test_nstep_sample_with_injected_draws_matches_jax(pushes):
    """n_step=3, stride=4 (= N_ENVS lockstep pushes).  2 pushes: the ring is
    under-filled and the clamp is reached; 21: it has wrapped.  The windows
    cross episode ends (p_done 0.15 + 0.05 a step)."""
    kw = dict(n_step=3, stride=N_ENVS)
    jbuf, jst, tbuf, tst = _pair(pushes, **kw)
    assert tbuf.fill(tst) == int(jbuf.fill(jst))
    key, b = jax.random.PRNGKey(pushes), 48
    want = jbuf.sample(jst, key, b)
    lo = 2 * N_ENVS
    raw = np.array(jax.random.randint(
        key, (b,), lo, max(int(jst.size), lo + 1)))
    idx = tbuf.draw(tst, None, b, raw=torch.from_numpy(raw).long())
    got = tbuf.sample_at(tst, idx)
    _assert_batch_equal(got, want, nstep=True)
    if pushes == 2:
        assert (raw > tst.size - 1).any()  # the clamp was exercised
    else:
        # some window was cut by an episode end, some ran its full length
        m = np.round(np.log(got.discount.numpy()) / np.log(0.99)).astype(int)
        assert set(m.tolist()) == {1, 2, 3}
    gen_idx = tbuf.draw(tst, torch.Generator().manual_seed(1), 2048)
    d = (tst.cursor - 1 - gen_idx) % CAP
    assert int(d.min()) >= min(lo, tst.size - 1) and int(d.max()) <= tst.size - 1


def test_nstep_window_that_reaches_the_cursor_is_cut():
    """A base transition right behind the cursor (as a PER draw can be) has
    one valid step: its window must not read past the cursor."""
    kw = dict(n_step=3, stride=N_ENVS)
    jbuf, jst, tbuf, tst = _pair(9, **kw)
    # indices 0, 1 and 2 pushes behind the cursor, on both sides
    idx = np.array([(tst.cursor - 1 - k * N_ENVS) % CAP for k in range(3)]
                   + [(tst.cursor - 1 - k * N_ENVS - 2) % CAP for k in range(3)])
    # no episode ends here, so only the cursor cuts the windows
    clear = lambda x: jnp.zeros_like(x)  # noqa: E731
    jst = jst.replace(data=jst.data.replace(
        terminated=clear(jst.data.terminated), truncated=clear(jst.data.truncated)))
    tst.data.terminated.zero_()
    tst.data.truncated.zero_()
    jidx = jnp.asarray(idx, jnp.int32)
    picked = jax.tree.map(lambda s: s[jidx], jst.data)
    want = jbuf._nstep_batch(jst, jidx, picked, jnp.ones((6,), jnp.float32))
    got = tbuf.sample_at(tst, torch.from_numpy(idx))
    _assert_batch_equal(got, want, nstep=True)
    np.testing.assert_allclose(
        got.discount.numpy(), np.float32(0.99) ** np.array([1, 2, 3] * 2),
        rtol=POW_RTOL)


@pytest.mark.parametrize("n_step", [1, 3])
@pytest.mark.parametrize("n_opts", [0, 600])
def test_per_sample_and_update_priority_match_jax(n_opts, n_step):
    kw = dict(n_step=n_step, stride=N_ENVS) if n_step > 1 else {}
    jbuf, jst, tbuf, tst = _pair(11, per=True, **kw)
    ix = np.array([0, 5, 17, 40], np.int32)
    td = np.array([4.0, 0.01, -1.5, 9.0], np.float32)
    jst = jbuf.update_priority(jst, jnp.asarray(ix), jnp.asarray(td))
    tst = tbuf.update_priority(tst, torch.from_numpy(ix), torch.from_numpy(td))
    np.testing.assert_allclose(tst.tree.sum_tree.numpy(),
                               np.asarray(jst.tree.sum_tree), rtol=POW_RTOL)
    np.testing.assert_allclose(tst.tree.max_priority.item(),
                               float(jst.tree.max_priority), rtol=POW_RTOL)
    # draw from the JAX tree's exact values on both sides
    tst = convert.replay_state(jst, device="cpu")
    key, b = jax.random.PRNGKey(n_opts + n_step), 32
    want = jbuf.sample(jst, key, b, n_opts=jnp.int32(n_opts))
    u = np.array(jax.random.uniform(key, (b,), jnp.float32))
    idx, w = tbuf.draw_per(tst, None, b, n_opts=n_opts, u=torch.from_numpy(u))
    got = tbuf.sample_at(tst, idx, w)
    _assert_batch_equal(got, want, nstep=n_step > 1)
    np.testing.assert_allclose(got.weight.numpy(), np.asarray(want.weight),
                               rtol=1e-5)
    assert len(got.weight.unique()) > 1 and float(got.weight.max()) <= 1 + 1e-6
    batch = tbuf.sample(tst, torch.Generator().manual_seed(0), 16, n_opts=n_opts)
    assert (tst.tree.sum_tree[CAP + batch.ix_sample.long()] > 0).all()


def test_constructor_checks_and_uniform_update_priority_is_a_no_op():
    with pytest.raises(ValueError, match="power-of-two"):
        ReplayBuffer(48, per=PerConfig(), device="cpu")
    with pytest.raises(ValueError, match="capacity too small"):
        ReplayBuffer(8, n_step=3, stride=4, device="cpu")
    buf = ReplayBuffer(CAP, device="cpu")
    assert buf.update_priority("state", None, None) == "state"
    assert buf.fill(buf.init(_example("torch"))) == 0
