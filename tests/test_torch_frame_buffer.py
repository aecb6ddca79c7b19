"""Port's FrameReplayBuffer vs the JAX package's, main-path modes.

Identical pushes (numpy data from a seed, with episode starts so the age
clamp of the union window is exercised) go into both buffers.  The JAX
state, carried across by ``convert.frame_replay_state``, must equal the
port's own.  Then the ``(e, s)`` draws that the JAX ``sample`` makes for a
key are recomputed from the same ``jax.random`` calls and injected into the
port's ``sample_at``.  Everything in the batch is copied data, so the
tolerance is zero: all fields equal bitwise.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from border_tpu.replay import FrameReplayBuffer as JaxFrameReplayBuffer
from border_tpu_torch import convert
from border_tpu_torch.replay import FrameReplayBuffer

N, CAP, HW = 3, 16, (12, 20)


def _pushes(steps, seed=0):
    """Per step: (prev_obs, act, reward, terminated, truncated, prev_len)
    with episodes ending at random, so the ring holds episode starts."""
    rng = np.random.default_rng(seed)
    ep_len = np.zeros(N, np.int32)
    out = []
    for _ in range(steps):
        obs = rng.integers(0, 256, (N, *HW, 4), dtype=np.uint8)
        act = rng.integers(0, 6, N, dtype=np.int32)
        rew = rng.choice([-1.0, 0.0, 1.0], N).astype(np.float32)
        term = rng.random(N) < 0.15
        trunc = ~term & (rng.random(N) < 0.05)
        out.append((obs, act, rew, term, trunc, ep_len.copy()))
        ep_len = np.where(term | trunc, 0, ep_len + 1).astype(np.int32)
    return out


def _ts(rew, term, trunc, xp):
    return types.SimpleNamespace(reward=xp(rew), terminated=xp(term),
                                 truncated=xp(trunc))


def _fill_both(steps, use_pallas=False):
    jbuf = JaxFrameReplayBuffer(capacity=CAP, num_envs=N, frame_hw=HW,
                                use_pallas=use_pallas)
    tbuf = FrameReplayBuffer(capacity=CAP, num_envs=N, frame_hw=HW,
                             device="cpu")
    jst, tst = jbuf.init(), tbuf.init()
    assert tbuf.fill(tst) == int(jbuf.fill(jst)) == 0
    for obs, act, rew, term, trunc, plen in _pushes(steps):
        jst = jbuf.process_step(jst, jnp.asarray(obs), jnp.asarray(act),
                                _ts(rew, term, trunc, jnp.asarray),
                                jnp.asarray(plen))
        tst = tbuf.process_step(tst, torch.from_numpy(obs),
                                torch.from_numpy(act),
                                _ts(rew, term, trunc, torch.from_numpy),
                                torch.from_numpy(plen))
        assert tbuf.fill(tst) == int(jbuf.fill(jst))
    return jbuf, jst, tbuf, tst


def _jax_draws(jbuf, jst, key, batch_size):
    """The (e, s) that ``JaxFrameReplayBuffer.sample`` draws for ``key``
    (uniform branch, frame_buffer.py:467-471)."""
    size = jnp.minimum(jst.total, jbuf.capacity)
    k_e, k_s = jax.random.split(key)
    e = jax.random.randint(k_e, (batch_size,), 0, jbuf.num_envs)
    lo = jst.total - size + jbuf.stack
    hi = jnp.maximum(jst.total - jbuf.n_step, lo + 1)
    s = jax.random.randint(k_s, (batch_size,), lo, hi)
    return (torch.from_numpy(np.asarray(e, np.int64)),
            torch.from_numpy(np.asarray(s, np.int64)))


def test_carried_state_equals_port_state():
    _, jst, tbuf, tst = _fill_both(CAP + 7)  # the ring has wrapped
    carried = convert.frame_replay_state(jst, frame_hw=HW)
    for name in ("frames", "act", "reward", "terminated", "truncated", "age"):
        assert torch.equal(getattr(carried, name), getattr(tst, name)), name
    assert carried.total == tst.total == CAP + 7


@pytest.mark.parametrize("steps", [9, CAP + 7])  # before and after the wrap
@pytest.mark.parametrize("use_pallas", [False, "interpret"])
def test_sample_at_injected_draws_matches_jax_sample(steps, use_pallas):
    # the interpreted Pallas kernel unrolls one DMA per (b, s) slot at
    # trace time, so it gets a smaller batch
    b = 12 if use_pallas else 64
    jbuf, jst, tbuf, tst = _fill_both(steps, use_pallas)
    key = jax.random.PRNGKey(steps)
    want = jbuf.sample(jst, key, b)
    e, s = _jax_draws(jbuf, jst, key, b)
    lo, hi = tbuf._draw_range(tst)
    assert lo <= int(s.min()) and int(s.max()) < hi
    got = tbuf.sample_at(convert.frame_replay_state(jst, frame_hw=HW), e, s)
    for name in ("obs", "next_obs", "act", "reward", "terminated",
                 "truncated", "ix_sample"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert got.obs.shape == (b, *HW, 4)
    # the draws reached episode starts, where the age clamp repeats the
    # episode's first frame into the stack
    if not use_pallas:
        assert (tst.age[e, s % CAP] < tbuf.stack - 1).any()
    # the port's own draw lands in the same range
    e2, s2 = tbuf.draw(tst, torch.Generator().manual_seed(0), 256)
    assert lo <= int(s2.min()) and int(s2.max()) < hi
    assert 0 <= int(e2.min()) and int(e2.max()) < N


def test_diagnostics_match():
    jbuf, jst, tbuf, tst = _fill_both(11)
    want, got = jbuf.diagnostics(jst), tbuf.diagnostics(tst)
    assert int(got["num_terminated"]) == int(want["num_terminated"])
    assert float(got["sum_rewards"]) == float(want["sum_rewards"])
    assert got["size"] == int(want["size"])


@pytest.mark.parametrize(
    "kw, item",
    [
        (dict(per=object()), "A.8"),
        (dict(n_step=3), "A.9"),
        (dict(sample_mode="separate"), "A.9"),
        (dict(sample_mode="slice"), "A.9"),
        (dict(sort_samples=True), "A.9"),
    ],
)
def test_unported_modes_raise(kw, item):
    with pytest.raises(ValueError, match=item):
        FrameReplayBuffer(capacity=CAP, num_envs=N, device="cpu", **kw)
