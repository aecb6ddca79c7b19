"""Port's bf16 Atari CNN and a DQN update on it vs the JAX package's bf16
ones, on the CPU.

Both sides start from the same parameters (float32, carried across by
``convert``) and compute in bf16, as the Pong paths do.  bf16 keeps 8 bits
of mantissa, and the two frameworks round their activations at other points
and sum the convolutions in other orders, so the checks are loose, with the
tolerances found on these inputs and a margin:

- Q values: within 2^-7 of the largest |Q| (two bf16 steps at that scale;
  seen: up to 1 step);
- the update's loss and TD errors: within 2^-6 of their scale;
- the new parameters: Adam's first step is about ``lr·sign(g)`` on both
  sides, so every step is at most ``lr`` (up to the rounding of θ + Δθ), and
  where the JAX gradient is large (above a tenth of its tensor's largest)
  the two steps agree in sign on at least 99% of the elements.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from border_tpu.agents import DQN as JaxDQN
from border_tpu.agents import DQNConfig as JaxDQNConfig
from border_tpu.core import spaces as jspaces
from border_tpu.models import AtariCNN as JaxAtariCNN
from border_tpu.replay.buffer import TransitionBatch as JaxBatch
from border_tpu_torch import convert
from border_tpu_torch.agents import DQN, DQNConfig
from border_tpu_torch.core import spaces
from border_tpu_torch.models import AtariCNN
from border_tpu_torch.replay import TransitionBatch

B, A, LR = 16, 6, 1e-4


def _frames(b, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, 84, 84, 4),
                                                dtype=np.uint8)


def test_bf16_forward_matches_jax_bf16():
    x = _frames(B, 0)
    for seed in range(3):
        jnet = JaxAtariCNN(out_dim=A)
        assert jnet.dtype == jnp.bfloat16
        params = jnet.init(jax.random.PRNGKey(seed), jnp.asarray(x[:1]))
        want = np.asarray(jnet.apply(params, jnp.asarray(x)), np.float32)
        net = convert.load_atari_cnn(AtariCNN(A), params)
        assert net.dtype == torch.bfloat16
        got = net(torch.from_numpy(x)).detach().float().numpy()
        assert got.shape == want.shape == (B, A)
        scale = np.abs(want).max()
        assert scale > 1e-2
        np.testing.assert_allclose(got, want, rtol=0, atol=2**-7 * scale)


def test_bf16_dqn_update_matches_jax_bf16():
    kw = dict(lr=LR, double_dqn=True, soft_update_interval=2, tau=1.0)
    jagent = JaxDQN(JaxDQNConfig(model=lambda n: JaxAtariCNN(n), **kw))
    tagent = DQN(DQNConfig(model=lambda n: AtariCNN(n), **kw))
    obs_space = jspaces.Box(0, 255, (84, 84, 4), jnp.uint8)
    jst = jagent.init(jax.random.PRNGKey(0), obs_space, jspaces.Discrete(A))
    jst = jst.replace(target_params=jagent.net.init(
        jax.random.PRNGKey(1), obs_space.zero()[None]))
    tst = convert.dqn_state(tagent, jst,
                            spaces.Box(0, 255, (84, 84, 4), torch.uint8),
                            spaces.Discrete(A), device="cpu")
    old = {k: v.clone().numpy() for k, v in tst.params.state_dict().items()}
    rng = np.random.default_rng(2)
    d = dict(obs=_frames(B, 3), act=rng.integers(0, A, B, dtype=np.int32),
             next_obs=_frames(B, 4),
             reward=rng.choice([-1.0, 0.0, 1.0], B).astype(np.float32),
             terminated=rng.random(B) < 0.25, truncated=np.zeros(B, bool))
    jb = JaxBatch(**{k: jnp.asarray(v) for k, v in d.items()},
                  weight=jnp.ones((B,), jnp.float32),
                  ix_sample=jnp.arange(B, dtype=jnp.int32))

    def jloss(p):  # the JAX update's loss, for its gradient
        q = jagent.net.apply(p, jb.next_obs)
        a_star = jnp.argmax(q, axis=-1)
        q_next = jnp.take_along_axis(
            jagent.net.apply(jst.target_params, jb.next_obs), a_star[:, None],
            -1)[:, 0]
        target = jb.reward + 0.99 * (1.0 - jb.terminated) * q_next
        pred = jnp.take_along_axis(jagent.net.apply(p, jb.obs),
                                   jb.act[:, None], -1)[:, 0]
        return pred, jax.lax.stop_gradient(target)

    jst1, jm, jtd = jax.jit(jagent.update)(jst, jb, jax.random.PRNGKey(2))
    tst1, tm, ttd = tagent.update(tst, TransitionBatch(
        **{k: torch.from_numpy(v) for k, v in d.items()}))

    loss_j, loss_t = float(jm["loss"]), tm["loss"].item()
    assert abs(loss_t - loss_j) <= 2**-6 * abs(loss_j)
    td_j, td_t = np.asarray(jtd, np.float32), ttd.float().numpy()
    np.testing.assert_allclose(td_t, td_j, rtol=0,
                               atol=2**-6 * np.abs(td_j).max())
    grads = convert.atari_cnn_state_dict(
        jax.grad(lambda p: jnp.mean(optax_huber(*jloss(p))))(jst.params))
    new = convert.atari_cnn_state_dict(jst1.params)
    for k, p in tst1.params.named_parameters():
        d_t = p.detach().numpy() - old[k]
        d_j = new[k].numpy() - old[k]
        # lr rounded to float32 (the optimizer's), and θ + Δθ rounded
        bound = np.float32(LR) * (1 + 2**-20) + 2 * np.spacing(np.abs(old[k]))
        assert (np.abs(d_t) <= bound).all() and (np.abs(d_j) <= bound).all(), k
        g = np.abs(grads[k].numpy())
        big = g > 0.1 * g.max()
        assert big.any(), k
        agree = (np.sign(d_t[big]) == np.sign(d_j[big])).mean()
        assert agree >= 0.99, (k, agree)
    assert tst1.n_opts == int(jst1.n_opts) == 1


def optax_huber(pred, target):
    """Smooth-L1 (Huber δ=1) per element, the DQN default loss."""
    d = pred - target
    a = jnp.abs(d)
    return jnp.where(a < 1.0, 0.5 * d * d, a - 0.5)
