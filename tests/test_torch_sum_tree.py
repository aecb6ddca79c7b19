"""The port's SumTree vs the JAX package's.

The same numpy-seeded update batches go into both trees.  Tree arrays,
totals, mins and weights agree to 1e-6 relative (float32 sums made in the
same ``left + right`` order; in practice they are equal).  The uniform
draws ``jax.random.uniform`` makes for a key are injected into the port's
``sample``, which must return the same leaves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from border_tpu.replay.sum_tree import SumTree as JaxSumTree
from border_tpu_torch import convert
from border_tpu_torch.replay import SumTree

CAP = 64
RTOL = 1e-6


def _batches(n_batches, k, seed=0, dups=True, dead=True):
    """(indices, priorities) update batches.  Duplicated indices carry one
    priority (JAX leaves the winner among different ones unspecified);
    some priorities are zero (dead leaves)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        idx = rng.integers(0, CAP, k).astype(np.int32)
        if dups:
            idx[k // 2:] = idx[: k - k // 2]  # every index at least twice
        pr = rng.random(CAP).astype(np.float32) * 3 + 0.01
        if dead:
            pr[rng.random(CAP) < 0.2] = 0.0
        out.append((idx, pr[idx]))
    return out


def _both(batches):
    jt, tt = JaxSumTree(CAP), SumTree(CAP, device="cpu")
    js, ts = jt.init(), tt.init()
    for idx, pr in batches:
        js = jt.update(js, jnp.asarray(idx), jnp.asarray(pr))
        ts = tt.update(ts, torch.from_numpy(idx), torch.from_numpy(pr))
    return jt, js, tt, ts


def _assert_trees_close(ts, js):
    for name in ("sum_tree", "min_tree", "max_priority"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)),
                                   rtol=RTOL, err_msg=name)


def test_init_matches():
    jt, tt = JaxSumTree(CAP - 3), SumTree(CAP - 3, device="cpu")
    assert tt.capacity == jt.capacity == CAP and tt.depth == jt.depth == 6
    _assert_trees_close(tt.init(), jt.init())


@pytest.mark.parametrize("dups", [False, True])
def test_update_totals_and_mins_match(dups):
    jt, js, tt, ts = _both(_batches(5, 24, dups=dups))
    _assert_trees_close(ts, js)
    np.testing.assert_allclose(tt.total(ts).item(), float(jt.total(js)), rtol=RTOL)
    np.testing.assert_allclose(tt.min_priority(ts).item(),
                               float(jt.min_priority(js)), rtol=RTOL)
    # the carried JAX state equals the port's own
    _assert_trees_close(convert.sum_tree_state(js, device="cpu"), js)
    # internal nodes are the sums and mins of their children
    s, m = ts.sum_tree, ts.min_tree
    torch.testing.assert_close(s[1:CAP], s[2::2] + s[3::2])
    assert torch.equal(m[1:CAP], torch.minimum(m[2::2], m[3::2]))
    # dead leaves: no mass, +inf in the min tree
    assert (s[CAP:] == 0).any()
    assert torch.equal(m[CAP:] == float("inf"), s[CAP:] == 0)


def test_duplicate_index_with_different_priorities_keeps_the_maximum():
    """The port's rule where JAX's result is unspecified: the leaf takes
    the largest priority written to it in the batch, in any order."""
    tt = SumTree(CAP, device="cpu")
    idx = torch.tensor([5, 9, 5, 5, 9, 2])
    pr = torch.tensor([0.5, 2.0, 3.0, 1.0, 0.25, 0.0])
    for perm in (torch.arange(6), torch.tensor([5, 4, 3, 2, 1, 0]),
                 torch.tensor([2, 0, 4, 5, 1, 3])):
        ts = tt.update(tt.init(), idx[perm], pr[perm])
        assert ts.sum_tree[CAP + 5].item() == 3.0
        assert ts.sum_tree[CAP + 9].item() == 2.0
        assert ts.sum_tree[CAP + 2].item() == 0.0
        assert ts.min_tree[CAP + 2].item() == float("inf")
        assert ts.sum_tree[1].item() == 5.0 and ts.min_tree[1].item() == 2.0
        assert ts.max_priority.item() == 3.0
    # an update overwrites: the old leaf value takes no part in the maximum
    ts = tt.update(ts, torch.tensor([5]), torch.tensor([0.125]))
    assert ts.sum_tree[CAP + 5].item() == 0.125
    assert ts.max_priority.item() == 3.0


@pytest.mark.parametrize("batch_size", [8, 32])
def test_sample_with_injected_uniforms_gives_identical_leaves(batch_size):
    jt, js, tt, ts = _both(_batches(4, 24, seed=1))
    for k in range(4):
        key = jax.random.PRNGKey(k)
        want = np.asarray(jt.sample(js, key, batch_size))
        u = np.array(jax.random.uniform(key, (batch_size,), jnp.float32))
        got = tt.sample(ts, batch_size, u=torch.from_numpy(u))
        np.testing.assert_array_equal(got.numpy(), want)
        assert (ts.sum_tree[CAP + got] > 0).all()  # never a dead leaf
    # the port's own draws: stratified, so leaves ascend; all live
    got = tt.sample(ts, 64, gen=torch.Generator().manual_seed(0))
    assert (got[1:] >= got[:-1]).all() and (ts.sum_tree[CAP + got] > 0).all()


def test_sample_never_returns_a_dead_leaf_at_the_right_edge():
    """A draw a float32 generator can return, u = 1 − 2^-24, puts the top
    stratum's mass point AT the total: (B − 1) + u rounds up to B.  The JAX
    descent then walks right into the dead half; the port's stays on the
    last live leaf."""
    b = 512
    jt, tt = JaxSumTree(CAP), SumTree(CAP, device="cpu")
    idx, pr = np.array([3, 10], np.int32), np.array([1.0, 2.0], np.float32)
    ts = tt.update(tt.init(), torch.from_numpy(idx), torch.from_numpy(pr))
    u = np.zeros(b, np.float32)
    u[-1] = 1 - 2.0 ** -24
    assert u[-1] < 1 and np.float32(b - 1) + u[-1] == b
    got = tt.sample(ts, b, u=torch.from_numpy(u))
    assert got[0].item() == 3 and got[-1].item() == 10
    assert (ts.sum_tree[CAP + got] > 0).all()

    js = jt.update(jt.init(), jnp.asarray(idx), jnp.asarray(pr))
    # the same mass points through the JAX descent (sum_tree.py:111-131),
    # by hand: its sample() takes a key, not the draws
    st = np.asarray(js.sum_tree)
    mass = (np.arange(b, dtype=np.float32) + u) * (st[1] / np.float32(b))
    nodes = np.ones(b, np.int64)
    for _ in range(jt.depth):
        left = 2 * nodes
        right = mass >= st[left]
        mass = np.where(right, mass - st[left], mass)
        nodes = np.where(right, left + 1, left)
    assert st[nodes[-1]] == 0.0  # the reference lands on a dead leaf
    live = st[nodes] > 0
    np.testing.assert_array_equal((nodes - CAP)[live], got.numpy()[live])


@pytest.mark.parametrize("normalize_all", [True, False])
def test_weights_match(normalize_all):
    jt, js, tt, ts = _both(_batches(4, 24, seed=2))
    key = jax.random.PRNGKey(7)
    leaves = np.asarray(jt.sample(js, key, 16))
    for n_valid, beta in ((40, 0.4), (57, 0.73), (64, 1.0)):
        want = jt.weights(js, jnp.asarray(leaves), jnp.int32(n_valid),
                          jnp.float32(beta), normalize_all)
        got = tt.weights(ts, torch.from_numpy(leaves), n_valid, beta,
                         normalize_all)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    if not normalize_all:
        assert got.max().item() == 1.0


def _cpu_state(seed=3):
    tt = SumTree(CAP, device="cpu")
    ts = tt.init()
    for idx, pr in _batches(2, 24, seed=seed):
        tt.update(ts, torch.from_numpy(idx), torch.from_numpy(pr))
    return ts


def _clone(ts):
    return type(ts)(*(x.clone() for x in (ts.sum_tree, ts.min_tree, ts.max_priority)))


@pytest.mark.parametrize("k", [0, 1, 24])
def test_wrappers_on_cpu_run_the_plain_loop_and_count_no_launch(k):
    """On CPU tensors the kernels' wrappers are the plain versions, K = 0
    included (no change), and count no launch."""
    from border_tpu_torch.ops import (sum_tree_sample, sum_tree_sample_ref,
                                      sum_tree_update, sum_tree_update_ref)

    ts, ref = _cpu_state(), _cpu_state()
    launches = (sum_tree_update.launches, sum_tree_update.captured,
                sum_tree_sample.launches, sum_tree_sample.captured)
    g = torch.Generator().manual_seed(k)
    idx = torch.randint(0, CAP, (k,), generator=g)
    pr = torch.rand(k, generator=g)
    before = _clone(ts)
    sum_tree_update(ts.sum_tree, ts.min_tree, ts.max_priority, idx, pr)
    sum_tree_update_ref(ref.sum_tree, ref.min_tree, ref.max_priority, idx, pr)
    for name in ("sum_tree", "min_tree", "max_priority"):
        assert torch.equal(getattr(ts, name), getattr(ref, name)), name
        if k == 0:
            assert torch.equal(getattr(ts, name), getattr(before, name)), name
    u = torch.rand(16, generator=g)
    assert torch.equal(sum_tree_sample(ts.sum_tree, u),
                       sum_tree_sample_ref(ref.sum_tree, u))
    assert (sum_tree_update.launches, sum_tree_update.captured,
            sum_tree_sample.launches, sum_tree_sample.captured) == launches


def test_wrappers_raise_on_a_device_with_no_kernel_and_on_bad_inputs():
    from border_tpu_torch.ops import sum_tree_sample, sum_tree_update

    meta = SumTree(CAP, device="meta").init()
    with pytest.raises(ValueError, match="no sum-tree kernel"):
        sum_tree_update(meta.sum_tree, meta.min_tree, meta.max_priority,
                        torch.zeros(3, dtype=torch.int64, device="meta"),
                        torch.ones(3, device="meta"))
    with pytest.raises(ValueError, match="no sum-tree kernel"):
        sum_tree_sample(meta.sum_tree, torch.rand(4, device="meta"))
    ts = _cpu_state()
    args = ts.sum_tree, ts.min_tree, ts.max_priority
    with pytest.raises(TypeError, match="int64"):
        sum_tree_update(*args, torch.zeros(3, dtype=torch.int32), torch.ones(3))
    with pytest.raises(TypeError, match="float32"):
        sum_tree_update(*args, torch.zeros(3, dtype=torch.int64),
                        torch.ones(3, dtype=torch.float64))
    with pytest.raises(ValueError, match="3 indices but 2 priorities"):
        sum_tree_update(*args, torch.zeros(3, dtype=torch.int64), torch.ones(2))
    with pytest.raises(ValueError, match="power of two"):
        sum_tree_sample(torch.zeros(2 * CAP + 2), torch.rand(4))
    with pytest.raises(TypeError, match="float32"):
        sum_tree_sample(ts.sum_tree, torch.rand(4, dtype=torch.float64))


def test_update_takes_a_stride_0_priority_of_its_own_max():
    """The flat ring's push writes ``max_priority.expand(n)``: a stride-0
    view of the state's own scalar, read before the scalar is updated."""
    tt = SumTree(CAP, device="cpu")
    ts, ref = _cpu_state(), _cpu_state()
    ts.max_priority.fill_(2.5)
    ref.max_priority.fill_(2.5)
    idx = torch.tensor([1, 7, 7, 40])
    tt.update(ts, idx, ts.max_priority.expand(4))
    tt.update(ref, idx, torch.full((4,), 2.5))
    for name in ("sum_tree", "min_tree", "max_priority"):
        assert torch.equal(getattr(ts, name), getattr(ref, name)), name
    assert ts.sum_tree[CAP + 7].item() == 2.5
