"""Port's FrameReplayBuffer vs the JAX package's, every sampling mode.

Identical pushes (numpy data from a seed, with episode starts so the age
clamp of the window is exercised) go into both buffers.  The JAX state,
carried across by ``convert.frame_replay_state``, must equal the port's
own.  Then the draws that the JAX ``sample`` makes for a key (``(e, s)``
for the uniform modes, the descent's uniforms for PER) are recomputed from
the same ``jax.random`` calls and injected into the port.  ``obs``,
``next_obs``, ``act``, ``terminated``, ``truncated`` and ``ix_sample`` are
copied data and must be equal bitwise; ``reward``, ``discount`` and
``weight`` (float32 arithmetic in n-step and PER) agree to 1e-6; the sum
tree's arrays agree to 1e-6.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from border_tpu.replay import FrameReplayBuffer as JaxFrameReplayBuffer
from border_tpu.replay import PerConfig as JaxPerConfig
from border_tpu_torch import convert
from border_tpu_torch.replay import FrameReplayBuffer, PerConfig

N, CAP, HW = 3, 16, (12, 20)
RTOL = 1e-6
EXACT = ("obs", "next_obs", "act", "terminated", "truncated", "ix_sample")
CLOSE = ("reward", "discount", "weight")


def _pushes(steps, seed=0, n=N):
    """Per step: (prev_obs, act, reward, terminated, truncated, prev_len)
    with episodes ending at random, so the ring holds episode starts."""
    rng = np.random.default_rng(seed)
    ep_len = np.zeros(n, np.int32)
    out = []
    for _ in range(steps):
        obs = rng.integers(0, 256, (n, *HW, 4), dtype=np.uint8)
        act = rng.integers(0, 6, n, dtype=np.int32)
        rew = rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32)
        term = rng.random(n) < 0.15
        trunc = ~term & (rng.random(n) < 0.05)
        out.append((obs, act, rew, term, trunc, ep_len.copy()))
        ep_len = np.where(term | trunc, 0, ep_len + 1).astype(np.int32)
    return out


def _ts(rew, term, trunc, xp):
    return types.SimpleNamespace(reward=xp(rew), terminated=xp(term),
                                 truncated=xp(trunc))


def _push_both(jbuf, jst, tbuf, tst, pushes):
    for obs, act, rew, term, trunc, plen in pushes:
        jst = jbuf.process_step(jst, jnp.asarray(obs), jnp.asarray(act),
                                _ts(rew, term, trunc, jnp.asarray),
                                jnp.asarray(plen))
        tst = tbuf.process_step(tst, torch.from_numpy(obs),
                                torch.from_numpy(act),
                                _ts(rew, term, trunc, torch.from_numpy),
                                torch.from_numpy(plen))
        assert tbuf.fill(tst) == int(jbuf.fill(jst))
    return jst, tst


def _fill_both(steps, use_pallas=False, n=N, per=False, **kw):
    """Both buffers after ``steps`` identical pushes; ``kw`` goes to both
    constructors."""
    jbuf = JaxFrameReplayBuffer(capacity=CAP, num_envs=n, frame_hw=HW,
                                use_pallas=use_pallas,
                                per=JaxPerConfig() if per else None, **kw)
    tbuf = FrameReplayBuffer(capacity=CAP, num_envs=n, frame_hw=HW,
                             per=PerConfig() if per else None, device="cpu",
                             **kw)
    jst, tst = jbuf.init(), tbuf.init()
    assert tbuf.fill(tst) == int(jbuf.fill(jst)) == 0
    jst, tst = _push_both(jbuf, jst, tbuf, tst, _pushes(steps, n=n))
    return jbuf, jst, tbuf, tst


def _carry(jst):
    return convert.frame_replay_state(jst, frame_hw=HW, capacity=CAP, device="cpu")


def _jax_draws(jbuf, jst, key, batch_size):
    """The (e, s) that ``JaxFrameReplayBuffer.sample`` draws for ``key``:
    the slice branch (frame_buffer.py:429-438) or the uniform one with its
    optional sort (:467-476)."""
    size = jnp.minimum(jst.total, jbuf.capacity)
    k_e, k_s = jax.random.split(key)
    lo = jst.total - size + jbuf.stack
    hi = jnp.maximum(jst.total - jbuf.n_step, lo + 1)
    if jbuf.sample_mode == "slice":
        g = jbuf.slice_group
        s_g = jax.random.randint(k_s, (batch_size // g,), lo, hi)
        e0 = g * jax.random.randint(k_e, (batch_size // g,), 0,
                                    jbuf.num_envs // g)
        e = (e0[:, None] + jnp.arange(g)[None, :]).reshape(-1)
        s = jnp.repeat(s_g, g)
    else:
        e = jax.random.randint(k_e, (batch_size,), 0, jbuf.num_envs)
        s = jax.random.randint(k_s, (batch_size,), lo, hi)
        if jbuf.sort_samples:
            order = jnp.argsort(e * jbuf.capacity + (s % jbuf.capacity))
            e, s = e[order], s[order]
    return (torch.from_numpy(np.asarray(e, np.int64)),
            torch.from_numpy(np.asarray(s, np.int64)))


def _assert_batches_match(got, want, b):
    """Port batch vs JAX batch; a ``None`` weight in the port means ones."""
    for name in EXACT + CLOSE:
        g, w = getattr(got, name), getattr(want, name)
        if name == "weight" and g is None:
            g = torch.ones(b)
        if w is None:
            assert g is None, name
            continue
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        if name in EXACT:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            assert g.dtype == torch.float32, name
            np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, err_msg=name)


def test_carried_state_equals_port_state():
    _, jst, tbuf, tst = _fill_both(CAP + 7)  # the ring has wrapped
    carried = convert.frame_replay_state(jst, frame_hw=HW, device="cpu")
    for name in ("frames", "act", "reward", "terminated", "truncated", "age"):
        assert torch.equal(getattr(carried, name), getattr(tst, name)), name
    assert carried.total == tst.total == CAP + 7
    assert carried.tree is None and tst.tree is None


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
    got = tbuf.sample_at(convert.frame_replay_state(jst, frame_hw=HW, device="cpu"), e, s)
    _assert_batches_match(got, want, b)
    assert got.weight is None  # uniform: "all ones"
    assert got.obs.shape == (b, *HW, 4)
    # the draws reached episode starts, where the age clamp repeats the
    # episode's first frame into the stack
    if not use_pallas:
        assert (tst.age[e, s % CAP] < tbuf.stack - 1).any()
    # the port's own draw lands in the same range
    e2, s2 = tbuf.draw(tst, torch.Generator().manual_seed(0), 256)
    assert lo <= int(s2.min()) and int(s2.max()) < hi
    assert 0 <= int(e2.min()) and int(e2.max()) < N


MODES = {
    "union": dict(),
    "separate": dict(sample_mode="separate"),
    "slice": dict(sample_mode="slice", slice_group=4),
    "sorted": dict(sort_samples=True),
    "nstep3": dict(n_step=3),
    "nstep3_separate": dict(n_step=3, sample_mode="separate"),
}


@pytest.mark.parametrize("steps", [11, CAP + 7])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_every_uniform_mode_matches_jax_sample(mode, steps):
    """Same pushes, the JAX draws injected: the port's batch equals the JAX
    buffer's in every field, ``weight`` (ones) included."""
    b, n = 32, 8
    jbuf, jst, tbuf, tst = _fill_both(steps, n=n, **MODES[mode])
    carried = _carry(jst)
    assert torch.equal(carried.frames, tst.frames)  # mirror slots included
    assert tst.frames.shape[1] == CAP + tbuf.slot_pad == jst.frames.shape[1]
    key = jax.random.PRNGKey(steps)
    want = jbuf.sample(jst, key, b)
    e, s = _jax_draws(jbuf, jst, key, b)
    got = tbuf.sample_at(carried, e, s)
    _assert_batches_match(got, want, b)
    if tbuf.n_step > 1:
        # the batch crosses episode boundaries: some returns stop early
        m = np.round(np.log(got.discount.numpy()) / np.log(tbuf.gamma))
        assert set(m.astype(int)) == {1, 2, 3}
    else:
        assert got.discount is None and want.discount is None


def test_separate_union_and_slice_give_the_same_values():
    """The three 1-step modes of the port on the same pushes and the same
    ``(e, s)``: bitwise the same batch."""
    n, pushes = 8, _pushes(CAP + 9, n=8)
    batches = {}
    for mode in ("union", "separate", "slice"):
        buf = FrameReplayBuffer(CAP, n, frame_hw=HW, sample_mode=mode,
                                slice_group=4, device="cpu")
        st = buf.init()
        for obs, act, rew, term, trunc, plen in pushes:
            st = buf.process_step(st, torch.from_numpy(obs),
                                  torch.from_numpy(act),
                                  _ts(rew, term, trunc, torch.from_numpy),
                                  torch.from_numpy(plen))
        if mode == "union":
            e, s = buf.draw(st, torch.Generator().manual_seed(1), 64)
            # the draws reach the wrap: windows that cross slot 0
            assert ((s % CAP) < buf.stack).any()
        batches[mode] = buf.sample_at(st, e, s)
    for mode in ("separate", "slice"):
        for name in EXACT + ("reward",):
            assert torch.equal(getattr(batches[mode], name),
                               getattr(batches["union"], name)), (mode, name)


def test_slice_draw_is_grouped_and_in_range():
    n, g, b = 8, 4, 64
    buf = FrameReplayBuffer(CAP, n, frame_hw=HW, sample_mode="slice",
                            slice_group=g, device="cpu")
    st = buf.init()
    st.total = CAP + 5  # the draw range depends on ``total`` only
    e, s = buf.draw(st, torch.Generator().manual_seed(0), b)
    lo, hi = buf._draw_range(st)
    assert e.shape == s.shape == (b,)
    e, s = e.view(-1, g), s.view(-1, g)
    assert (e[:, 0] % g == 0).all()  # aligned blocks of env columns
    assert torch.equal(e, e[:, :1] + torch.arange(g))
    assert (s == s[:, :1]).all()  # group-mates share the step
    assert lo <= int(s.min()) and int(s.max()) < hi
    assert len(s[:, 0].unique()) > 1 and len(e[:, 0].unique()) > 1
    with pytest.raises(ValueError, match="must divide batch_size"):
        buf.draw(st, torch.Generator().manual_seed(0), b + 1)


def test_sort_samples_is_a_permutation_of_the_unsorted_batch():
    _, _, plain, st = _fill_both(CAP + 7)
    sort = FrameReplayBuffer(CAP, N, frame_hw=HW, sort_samples=True,
                             device="cpu")
    e, s = plain.draw(st, torch.Generator().manual_seed(5), 48)
    e2, s2 = sort.draw(st, torch.Generator().manual_seed(5), 48)
    key, key2 = e * CAP + s % CAP, e2 * CAP + s2 % CAP
    assert (key2[1:] >= key2[:-1]).all() and not (key[1:] >= key[:-1]).all()
    order = torch.argsort(key, stable=True)
    assert torch.equal(e2, e[order]) and torch.equal(s2, s[order])
    a, b = plain.sample_at(st, e, s), sort.sample_at(st, e2, s2)
    for name in EXACT + ("reward",):
        assert torch.equal(getattr(b, name), getattr(a, name)[order]), name


def _per_pair(steps, n_step=1):
    return _fill_both(steps, n=4, per=True, n_step=n_step)


def _assert_trees_close(tst, jst):
    for name in ("sum_tree", "min_tree", "max_priority"):
        np.testing.assert_allclose(
            getattr(tst.tree, name).numpy(), np.asarray(getattr(jst.tree, name)),
            rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("n_step", [1, 3])
@pytest.mark.parametrize("steps", [3, 9, CAP + 7])
def test_per_residency_after_identical_pushes(steps, n_step):
    """The tree after pushes: equal to the JAX tree.  Its live leaves are
    the uniform draw range's (env, slot) pairs, and once the ring has
    wrapped one older step too: the uniform range leaves out the step whose
    stack starts at the slot the NEXT push overwrites; the tree kills it
    only then."""
    jbuf, jst, tbuf, tst = _per_pair(steps, n_step)
    _assert_trees_close(tst, jst)
    _assert_trees_close(_carry(jst), jst)
    live = (tst.tree.sum_tree[tbuf.tree.capacity:] > 0).view(4, CAP)
    lo, hi = tbuf._draw_range(tst)
    want = torch.zeros(CAP, dtype=torch.bool)
    if tbuf.fill(tst):
        lo_tree = max(tst.total - CAP + tbuf.stack - 1, tbuf.stack)
        assert lo_tree in (lo, lo - 1)
        want[torch.arange(lo_tree, hi) % CAP] = True
    assert torch.equal(live, want.expand(4, -1))
    assert int(live.sum()) >= tbuf.fill(tst) == int(jbuf.fill(jst))


def test_per_new_steps_enter_at_the_running_max_priority():
    """Priority feedback raises the max; later pushes enter at it.  The
    fed-back indices are distinct (JAX leaves duplicates unspecified)."""
    jbuf, jst, tbuf, tst = _per_pair(CAP + 3)
    lo, hi = tbuf._draw_range(tst)
    s = torch.arange(lo, lo + 6)
    ix = (torch.arange(6) % 4) * CAP + s % CAP
    td = torch.tensor([0.5, -7.0, 2.0, 0.0, -0.25, 3.5])
    jst = jbuf.update_priority(jst, jnp.asarray(ix.numpy(), jnp.int32),
                               jnp.asarray(td.numpy()))
    tst = tbuf.update_priority(tst, ix.to(torch.int32), td)
    _assert_trees_close(tst, jst)
    want_max = (7.0 + 1e-6) ** 0.6
    np.testing.assert_allclose(tst.tree.max_priority.item(), want_max, rtol=RTOL)
    jst, tst = _push_both(jbuf, jst, tbuf, tst, _pushes(2, seed=3, n=4))
    _assert_trees_close(tst, jst)
    newest = (tst.total - 1 - tbuf.n_step) % CAP
    leaves = tst.tree.sum_tree[tbuf.tree.capacity:].view(4, CAP)
    np.testing.assert_allclose(leaves[:, newest].numpy(), want_max, rtol=RTOL)


@pytest.mark.parametrize("n_step", [1, 3])
@pytest.mark.parametrize("n_opts", [0, 30_000])
def test_per_sample_with_injected_uniforms_matches_jax(n_opts, n_step):
    b = 32
    jbuf, jst, tbuf, tst = _per_pair(CAP + 7, n_step)
    # uneven priorities, so the descent and the weights have work to do
    lo, _ = tbuf._draw_range(tst)
    ix = torch.arange(4) * CAP + (lo + torch.arange(4)) % CAP
    td = torch.tensor([4.0, 0.01, 1.5, 9.0])
    jst = jbuf.update_priority(jst, jnp.asarray(ix.numpy(), jnp.int32),
                               jnp.asarray(td.numpy()))
    tst = tbuf.update_priority(tst, ix.to(torch.int32), td)
    key = jax.random.PRNGKey(n_opts + n_step)
    want = jbuf.sample(jst, key, b, n_opts=jnp.int32(n_opts))
    u = np.array(jax.random.uniform(key, (b,), jnp.float32))
    e, s, w = tbuf.draw_per(_carry(jst), None, b, n_opts=n_opts,
                            u=torch.from_numpy(u))
    lo, hi = tbuf._draw_range(tst)
    assert lo - 1 <= int(s.min()) and int(s.max()) < hi  # residency
    got = tbuf.sample_at(tst, e, s, weight=w)
    _assert_batches_match(got, want, b)
    assert got.weight is not None and len(got.weight.unique()) > 1
    assert float(got.weight.max()) <= 1.0 + 1e-6
    # the port's own draw (its generator) is resident too
    batch = tbuf.sample(tst, torch.Generator().manual_seed(0), 64, n_opts=n_opts)
    p = batch.ix_sample.long()
    assert (tst.tree.sum_tree[tbuf.tree.capacity + p] > 0).all()


def test_update_priority_with_a_leaf_sampled_twice_keeps_the_larger():
    _, _, tbuf, tst = _per_pair(CAP + 7)
    lo, _ = tbuf._draw_range(tst)
    leaf = 2 * CAP + lo % CAP
    ix = torch.tensor([leaf, leaf + 1, leaf], dtype=torch.int32)
    for td in ([0.5, 1.0, -3.0], [-3.0, 1.0, 0.5]):
        tbuf.update_priority(tst, ix, torch.tensor(td))
        np.testing.assert_allclose(
            tst.tree.sum_tree[tbuf.tree.capacity + leaf].item(),
            (3.0 + 1e-6) ** 0.6, rtol=RTOL)
    assert FrameReplayBuffer(CAP, N, device="cpu").update_priority(
        "state", ix, ix) == "state"  # uniform: a no-op


def test_diagnostics_match():
    jbuf, jst, tbuf, tst = _fill_both(11)
    want, got = jbuf.diagnostics(jst), tbuf.diagnostics(tst)
    assert int(got["num_terminated"]) == int(want["num_terminated"])
    assert float(got["sum_rewards"]) == float(want["sum_rewards"])
    assert got["size"] == int(want["size"])


@pytest.mark.parametrize(
    "kw, item",
    [
        (dict(sample_mode="bogus"), "sample_mode must be"),
        (dict(sample_mode="slice", per=True), "uniform-only"),
        (dict(sample_mode="slice", n_step=3), "n_step=1"),
        (dict(sample_mode="slice", slice_group=5), "must divide num_envs"),
        (dict(per=True, num_envs=3), "power of two"),
        (dict(per=True, capacity=4), "capacity > stack"),
    ],
)
def test_unported_modes_raise(kw, item):
    """No mode of the JAX buffer is unported any more: what raises is what
    the JAX constructor refuses, with its messages."""
    kw = dict(dict(capacity=CAP, num_envs=4), **kw)
    per = kw.pop("per", False)
    with pytest.raises(ValueError, match=item) as jerr:
        JaxFrameReplayBuffer(per=JaxPerConfig() if per else None, **kw)
    with pytest.raises(ValueError, match=item) as terr:
        FrameReplayBuffer(per=PerConfig() if per else None, device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)
