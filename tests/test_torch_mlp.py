"""Port's MLP models and the DQN-on-MLP update vs the JAX package.

The same numpy-seeded inputs go through the flax module and, with its
parameters carried across by ``convert.mlp_state_dict``, through the port's.
Forward passes agree to atol 1e-5 in float32 (two matmul libraries sum in
another order); one DQN update from identical state agrees in loss,
``td_err`` and new parameters to atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from border_tpu.agents import DQN as JaxDQN
from border_tpu.agents import DQNConfig as JaxDQNConfig
from border_tpu.core import spaces as jspaces
from border_tpu.models import mlp as jmlp
from border_tpu.replay.buffer import TransitionBatch as JaxBatch
from border_tpu_torch import convert
from border_tpu_torch.agents import DQN, DQNConfig
from border_tpu_torch.core import spaces
from border_tpu_torch.models import ACTIVATIONS, MLP, DuelingMLP, GaussianHeadMLP
from border_tpu_torch.replay import TransitionBatch

ATOL = 1e-5
IN, OUT, B = 5, 3, 16


def _x(seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(B, IN)) * scale).astype(
        np.float32)


@pytest.mark.parametrize("kind", ["mlp", "dueling", "gaussian"])
@pytest.mark.parametrize("activation", ["relu", "tanh", "gelu"])
def test_forward_matches_flax(kind, activation):
    hidden = (12, 7)
    if kind == "gaussian":
        jnet = jmlp.GaussianHeadMLP(act_dim=OUT, hidden=hidden,
                                    activation=activation, log_std_max=0.05)
        tnet = GaussianHeadMLP(IN, OUT, hidden, activation, log_std_max=0.05)
    else:
        jcls, tcls = {"mlp": (jmlp.MLP, MLP),
                      "dueling": (jmlp.DuelingMLP, DuelingMLP)}[kind]
        jnet = jcls(out_dim=OUT, hidden=hidden, activation=activation)
        tnet = tcls(IN, OUT, hidden, activation)
    x = _x(0, scale=3.0)
    params = jnet.init(jax.random.PRNGKey(1), jnp.asarray(x))
    # flax starts biases at zero: give them values so a swapped bias shows
    params = jax.tree.map(
        lambda p: p + 0.1 * jnp.arange(p.size, dtype=p.dtype).reshape(p.shape)
        / p.size if p.ndim == 1 else p, params)
    tnet.load_state_dict(convert.mlp_state_dict(tnet, params))
    want = jnet.apply(params, jnp.asarray(x))
    got = tnet(torch.from_numpy(x))
    if kind == "gaussian":
        assert (np.asarray(want[1]) == 0.05).any()  # the clamp is reached
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=ATOL)
    else:
        assert got.dtype == torch.float32 and tuple(got.shape) == (B, OUT)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)


def test_activations_match_and_bf16_compute_returns_float32():
    x = np.linspace(-3, 3, 31, dtype=np.float32)
    assert set(ACTIVATIONS) == set(jmlp.ACTIVATIONS)
    for name, fn in ACTIVATIONS.items():
        np.testing.assert_allclose(
            fn(torch.from_numpy(x)).numpy(),
            np.asarray(jmlp.ACTIVATIONS[name](jnp.asarray(x))), atol=1e-6,
            err_msg=name)
    net = MLP(IN, OUT, (8,), dtype=torch.bfloat16)
    net.reset_parameters(torch.Generator().manual_seed(0))
    out = net(torch.from_numpy(_x(1)))
    assert out.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in net.parameters())


def test_reset_parameters_is_lecun_normal_with_zero_biases():
    net = MLP(400, 300, (500,))
    net.reset_parameters(torch.Generator().manual_seed(0))
    for m, fan_in in ((net.layers[0], 400), (net.out, 500)):
        assert (m.bias == 0).all()
        assert m.weight.std().item() == pytest.approx(fan_in ** -0.5, rel=0.02)
        # truncated at 2 sigma of the untruncated normal
        assert m.weight.abs().max().item() <= 2 * fan_in ** -0.5 / 0.8796 + 1e-6
    same = MLP(400, 300, (500,))
    same.reset_parameters(torch.Generator().manual_seed(0))
    assert torch.equal(same.out.weight, net.out.weight)


# -- one DQN update on the default MLP / the dueling MLP --------------------

CONFIGS = {
    "default": dict(double_dqn=True, hidden=(16, 16), soft_update_interval=1,
                    tau=0.005),
    "dueling": dict(dueling=True, hidden=(16,), lr=5e-4, loss="mse"),
}


def _batch(seed, nstep):
    rng = np.random.default_rng(seed)
    d = dict(
        obs=rng.normal(size=(B, 4)).astype(np.float32),
        act=rng.integers(0, 2, B, dtype=np.int32),
        next_obs=rng.normal(size=(B, 4)).astype(np.float32),
        reward=rng.normal(size=B).astype(np.float32),
        terminated=rng.random(B) < 0.25,
        truncated=np.zeros(B, bool),
    )
    if nstep:
        d["discount"] = (0.99 ** rng.integers(1, 4, B)).astype(np.float32)
    return d


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_one_mlp_update_matches_jax(name):
    kw = CONFIGS[name]
    jagent, tagent = JaxDQN(JaxDQNConfig(**kw)), DQN(DQNConfig(**kw))
    jspace = jspaces.Box(-1.0, 1.0, (4,), jnp.float32)
    jst = jagent.init(jax.random.PRNGKey(0), jspace, jspaces.Discrete(2))
    other = jagent.net.init(jax.random.PRNGKey(1), jspace.zero()[None])
    jst = jst.replace(target_params=other, n_samples=jnp.int32(5_000))
    tst = convert.dqn_state(
        tagent, jst, spaces.Box(-1.0, 1.0, (4,), torch.float32),
        spaces.Discrete(2), device="cpu")
    assert type(tst.params).__name__ == (
        "DuelingMLP" if name == "dueling" else "MLP")
    d = _batch(3, nstep=name == "default")
    jb = JaxBatch(**{k: jnp.asarray(v) for k, v in d.items()},
                  weight=jnp.ones((B,), jnp.float32),
                  ix_sample=jnp.arange(B, dtype=jnp.int32))
    jst1, jm, jtd = jax.jit(jagent.update)(jst, jb, jax.random.PRNGKey(2))
    tst1, tm, ttd = tagent.update(
        tst, TransitionBatch(**{k: torch.from_numpy(v) for k, v in d.items()}))

    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), atol=ATOL)
    np.testing.assert_allclose(tm["q_mean"].item(), float(jm["q_mean"]), atol=ATOL)
    np.testing.assert_allclose(ttd.numpy(), np.asarray(jtd), atol=ATOL)
    assert tm["epsilon"] == float(jm["epsilon"])
    for st_name in ("params", "target_params"):
        tnet = getattr(tst1, st_name)
        want = convert.mlp_state_dict(tnet, getattr(jst1, st_name))
        for k, v in tnet.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=ATOL,
                                       err_msg=f"{st_name}.{k}")
    # the update moved the parameters by more than the tolerance
    before = convert.mlp_state_dict(tst1.params, jst.params)
    assert max((v - before[k]).abs().max().item()
               for k, v in tst1.params.state_dict().items()) > 10 * ATOL
    assert tst1.n_opts == int(jst1.n_opts) == 1


def test_default_config_initialises_acts_and_updates():
    """``DQN()`` with no model builds an MLP sized from the spaces."""
    agent = DQN()
    obs_space = spaces.Box(-1.0, 1.0, (4,), torch.float32)
    st = agent.init(0, obs_space, spaces.Discrete(2), device="cpu")
    assert isinstance(st.params, MLP) and st.params.layers[0].in_features == 4
    d = _batch(4, nstep=False)
    batch = TransitionBatch(**{k: torch.from_numpy(v) for k, v in d.items()})
    st, metrics, td = agent.update(st, batch)
    assert np.isfinite(metrics["loss"].item()) and tuple(td.shape) == (B,)
    act = agent.select_action(st, batch.obs, torch.Generator().manual_seed(0))
    assert act.dtype == torch.int32 and ((act >= 0) & (act < 2)).all()
