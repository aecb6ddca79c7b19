"""Port's Gaussian policy helpers vs the JAX package's.

The same numpy-seeded means and log-stds go through both; the JAX key's
standard-normal draws are recomputed and injected into the port's
``sample``.  Float32, tolerance atol 1e-6 / rtol 1e-6 (1e-5 relative on
log-probabilities of a few hundred, which sum eight terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from border_tpu.agents import gaussian as jg
from border_tpu_torch.agents import gaussian

B, D = 64, 8
TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    mean = rng.normal(size=(B, D)).astype(np.float32) * 2
    log_std = rng.uniform(-5, 2, (B, D)).astype(np.float32)
    return mean, log_std


@pytest.mark.parametrize("limit", ["tanh", "clamp"])
@pytest.mark.parametrize("seed", [0, 1])
def test_sample_matches_jax(limit, seed):
    mean, log_std = _inputs(seed)
    key = jax.random.PRNGKey(seed)
    wa, wlogp = jg.sample(key, jnp.asarray(mean), jnp.asarray(log_std), limit,
                          -0.5, 0.75)
    z = torch.from_numpy(np.array(jax.random.normal(key, (B, D))))
    ga, glogp = gaussian.sample(None, torch.from_numpy(mean),
                                torch.from_numpy(log_std), limit, -0.5, 0.75, z=z)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), **TOL)
    np.testing.assert_allclose(glogp.numpy(), np.asarray(wlogp), rtol=1e-5, atol=1e-5)
    if limit == "clamp":
        assert ga.min() == -0.5 and ga.max() == 0.75  # the bounds are reached
    else:
        assert (ga.abs() <= 1).all()


def test_sample_draws_from_the_generator():
    mean, log_std = (torch.from_numpy(x) for x in _inputs(2))
    a1, l1 = gaussian.sample(torch.Generator().manual_seed(3), mean, log_std, "tanh")
    a2, l2 = gaussian.sample(torch.Generator().manual_seed(3), mean, log_std, "tanh")
    a3, _ = gaussian.sample(torch.Generator().manual_seed(4), mean, log_std, "tanh")
    assert torch.equal(a1, a2) and torch.equal(l1, l2) and not torch.equal(a1, a3)


@pytest.mark.parametrize("limit", ["tanh", "clamp"])
def test_logp_of_matches_jax(limit):
    mean, log_std = _inputs(5)
    rng = np.random.default_rng(6)
    act = rng.uniform(-1, 1, (B, D)).astype(np.float32)
    act[0, :3] = [1.0, -1.0, 0.9999999]  # clipped to ±0.999995 before atanh
    want = jg.logp_of(jnp.asarray(act), jnp.asarray(mean), jnp.asarray(log_std), limit)
    got = gaussian.logp_of(torch.from_numpy(act), torch.from_numpy(mean),
                           torch.from_numpy(log_std), limit)
    assert np.isfinite(np.asarray(want)).all() and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_normal_logp_and_softplus_match_jax():
    mean, log_std = _inputs(8)
    u = np.random.default_rng(9).normal(size=(B, D)).astype(np.float32)
    np.testing.assert_allclose(
        gaussian.normal_logp(*(torch.from_numpy(x) for x in (u, mean, log_std))).numpy(),
        np.asarray(jg.normal_logp(*(jnp.asarray(x) for x in (u, mean, log_std)))),
        rtol=1e-5, atol=1e-5)
    # logaddexp(x, 0) on both sides, also past F.softplus's threshold of 20
    x = np.array([-90.0, -30.0, -1.0, 0.0, 0.5, 19.0, 20.5, 25.0, 90.0], np.float32)
    np.testing.assert_allclose(gaussian.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))), **TOL)
    # the stable tanh Jacobian equals the naive one where that one is exact
    uu = torch.linspace(-3, 3, 61)
    torch.testing.assert_close(
        gaussian.tanh_log_det(uu[:, None]),
        torch.log(1 - torch.tanh(uu) ** 2), rtol=1e-5, atol=1e-5)
