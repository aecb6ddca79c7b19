"""The port's Evaluator vs the JAX package's.

The rollout logic is held on a deterministic counting env written for both
packages: the same initial states (per-instance horizons) and the same
actions (a function of the observation) go through both evaluators, which
must report the same returns, lengths and truncated count (float32 sums of
a few multiples of 0.5: equal, tolerance 1e-6).  The JAX keys and the
port's generators cannot match, so ``reset_with_index`` is replaced on both
sides by the hand-built states; its own contract (repeatable per index,
distinct across indices) is tested on Pong.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from border_tpu.core.env import Environment as JaxEnvironment
from border_tpu.core.env import VecEnvState as JaxVecEnvState
from border_tpu.train import Evaluator as JaxEvaluator
from border_tpu_torch.agents import DQN, DQNConfig
from border_tpu_torch.core.env import Environment, VecEnv, VecEnvState, index_seed
from border_tpu_torch.envs import make, registry
from border_tpu_torch.models import AtariCNN
from border_tpu_torch.train import Evaluator
from border_tpu_torch.train.evaluator import _CHECK_EVERY
from border_tpu_torch.train.graphs import _leaves

KEYS = {"Episode return", "Episode return min", "Episode return max",
        "Episode length", "Episodes truncated"}


class JaxCountdown(JaxEnvironment):
    """One instance: counts steps, ends at its ``horizon``; reward
    ``1 + action / 2``; the observation is the step count."""

    @property
    def default_params(self):
        return None

    def reset_env(self, key, params):
        st = {"t": jnp.int32(0), "horizon": jnp.int32(10**6)}
        return jnp.zeros((1,), jnp.float32), st

    def step_env(self, key, state, action, params):
        t = state["t"] + 1
        reward = 1.0 + 0.5 * action.astype(jnp.float32)
        return (t.astype(jnp.float32)[None], {"t": t, "horizon": state["horizon"]},
                reward, t >= state["horizon"], jnp.bool_(False), {})


@dataclasses.dataclass
class CountState:
    t: torch.Tensor
    horizon: torch.Tensor


class Countdown(Environment):
    """The batched counterpart; counts its ``step_env`` calls."""

    def __init__(self):
        self.steps = 0

    @property
    def default_params(self):
        return None

    def reset_env(self, gen, n, params, device):
        st = CountState(t=torch.zeros(n, dtype=torch.int32),
                        horizon=torch.full((n,), 10**6, dtype=torch.int32))
        return torch.zeros((n, 1)), st

    def step_env(self, gen, state, action, params):
        self.steps += 1
        t = state.t + 1
        reward = 1.0 + 0.5 * action.float()
        return (t.float()[:, None], CountState(t=t, horizon=state.horizon),
                reward, t >= state.horizon, torch.zeros_like(t, dtype=torch.bool),
                {})


class JaxPolicy:
    def select_action_eval(self, state, obs, key):
        return (obs[:, 0].astype(jnp.int32) * 7) % 3


class Policy:
    def policy_params(self, state):
        return None

    def select_action_eval(self, state, obs, gen=None):
        return (obs[:, 0].to(torch.int32) * 7) % 3


def _evaluators(horizons, max_steps):
    """Both evaluators with ``reset_with_index`` returning the same
    hand-built states."""
    n = len(horizons)
    h = np.asarray(horizons, np.int32)
    jev = JaxEvaluator(JaxCountdown(), n_episodes=n, max_steps=max_steps)
    zf, zi = jnp.zeros((n,), jnp.float32), jnp.zeros((n,), jnp.int32)
    jstate = JaxVecEnvState(
        env_state={"t": zi, "horizon": jnp.asarray(h)},
        obs=jnp.zeros((n, 1), jnp.float32), episode_return=zf,
        episode_length=zi, last_return=zf, last_length=zi,
        key=jax.random.PRNGKey(0))
    jev.vec.reset_with_index = lambda key, index: jstate

    env = Countdown()
    tev = Evaluator(env, n_episodes=n, max_steps=max_steps, device="cpu")

    def reset(base_seed, index, gen=None):
        ti = torch.zeros(n, dtype=torch.int32)
        return VecEnvState(
            env_state=CountState(t=ti, horizon=torch.tensor(h)),
            obs=torch.zeros((n, 1)), episode_return=torch.zeros(n),
            episode_length=ti.clone(), last_return=torch.zeros(n),
            last_length=ti.clone(), gen=(gen or torch.Generator()).manual_seed(0))

    tev.vec.reset_with_index = reset
    return jev, tev, env


@pytest.mark.parametrize(
    "horizons, max_steps",
    [
        ([3, 5, 9, 12], 10),  # one instance runs into the cap
        ([1, 2, 30, 7, 8], 1_000),  # all end; the loop exits early
        ([40, 50], 20),  # every instance truncated
    ],
)
def test_rollout_matches_jax_evaluator(horizons, max_steps):
    jev, tev, env = _evaluators(horizons, max_steps)
    jret, jlen, jtrunc = jev._rollout(JaxPolicy(), None, jnp.int32(0))
    tret, tlen, ttrunc = tev._rollout(Policy(), None, 0)
    np.testing.assert_allclose(tret.numpy(), np.asarray(jret), rtol=1e-6)
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    assert int(ttrunc) == int(jtrunc) == sum(h > max_steps for h in horizons)
    # by hand: lengths stop at the horizon or the cap
    want_len = [min(h, max_steps) for h in horizons]
    assert tlen.tolist() == want_len
    want_ret = [sum(1.0 + 0.5 * ((7 * t) % 3) for t in range(k)) for k in want_len]
    np.testing.assert_allclose(tret.numpy(), want_ret, rtol=1e-6)

    jscore, jrec = jev.evaluate(JaxPolicy(), None, 0)
    tscore, trec = tev.evaluate(Policy(), None, 0)
    assert {k for k, _ in trec} == {k for k, _ in jrec} == KEYS
    np.testing.assert_allclose(tscore, jscore, rtol=1e-6)
    for k in KEYS:
        np.testing.assert_allclose(trec.get_scalar(k), jrec.get_scalar(k),
                                   rtol=1e-6, err_msg=k)


def test_rollout_exits_early_within_the_check_interval():
    """Every episode is over after 30 steps of a 1000-step cap: the loop
    stops at the next multiple of ``_CHECK_EVERY``."""
    _, tev, env = _evaluators([1, 2, 30, 7, 8], 1_000)
    tev._rollout(Policy(), None, 0)
    assert env.steps == -(-30 // _CHECK_EVERY) * _CHECK_EVERY == 32
    # the cap need not be a multiple of the interval
    _, tev, env = _evaluators([40, 50], 20)
    tev._rollout(Policy(), None, 0)
    assert env.steps == 20


def test_reset_with_index_is_repeatable_and_distinct():
    vec = VecEnv(make("Pong-v0", train=False), 6, device="cpu")
    a, b, c = (vec.reset_with_index(7, 3), vec.reset_with_index(7, 3),
               vec.reset_with_index(7, 4))
    for f in dataclasses.fields(a.env_state.game):
        assert torch.equal(getattr(a.env_state.game, f.name),
                           getattr(b.env_state.game, f.name)), f.name
    assert torch.equal(a.obs, b.obs)
    assert not torch.equal(a.env_state.game.agent_y, c.env_state.game.agent_y)
    assert not torch.equal(a.obs, c.obs)
    assert not torch.equal(a.obs, vec.reset_with_index(8, 3).obs)
    # the generator goes on from the reset: the serve draws repeat too
    assert torch.equal(torch.rand(4, generator=a.gen), torch.rand(4, generator=b.gen))
    assert index_seed(7, 3) == 7 * 1_000_003 + 3 != index_seed(3, 7)


@pytest.mark.parametrize("env_id", sorted(registry))
def test_reset_with_index_on_the_cpu_is_the_index_seeded_reset(env_id):
    """On the CPU an index's reset is the env's reset from a CPU generator
    seeded with ``index_seed``, bitwise, and ``state.gen`` is that generator
    continued: the same episode starts on every device (the card's reset is
    made on the CPU and copied, ``test_torch_cuda.py``)."""
    env = make(env_id)
    vec = VecEnv(env, 3, device="cpu")
    for index in (0, 1, 10_007):
        got = vec.reset_with_index(7, index)
        gen = torch.Generator().manual_seed(7 * 1_000_003 + index)
        obs, st = env.reset_env(gen, 3, env.default_params, torch.device("cpu"))
        want = dict(_leaves({"obs": obs, "state": st}))
        have = dict(_leaves({"obs": got.obs, "state": got.env_state}))
        assert have.keys() == want.keys()
        for k, v in want.items():
            assert have[k].dtype == v.dtype and torch.equal(have[k], v), (index, k)
        assert torch.equal(got.gen.get_state(), gen.get_state())
        assert not got.episode_return.any() and not got.episode_length.any()
        # gen=: that generator, re-seeded in place, draws the same resets
        held = torch.Generator().manual_seed(123)
        again = vec.reset_with_index(7, index, gen=held)
        assert again.gen is held
        assert torch.equal(held.get_state(), gen.get_state())
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
            _leaves(again.env_state), _leaves(got.env_state), strict=True))


def test_evaluate_pong_with_dqn_on_the_cpu():
    """The evaluator on the real env and agent: five keys, a whole rollout
    of ``max_steps`` (no Pong game ends in 6 steps), same result when
    repeated with the same index."""
    env = make("Pong-v0", train=False)
    agent = DQN(DQNConfig(model=lambda n: AtariCNN(n, dtype=torch.float32)))
    state = agent.init(0, env.observation_space(None), env.action_space(None),
                       device="cpu")
    ev = Evaluator(env, n_episodes=3, max_steps=6, device="cpu")
    score, rec = ev.evaluate(agent, state, eval_index=2)
    assert {k for k, _ in rec} == KEYS
    assert rec.get_scalar("Episode length") == 6.0
    assert rec.get_scalar("Episodes truncated") == 3.0
    assert score == rec.get_scalar("Episode return") == 0.0
    assert ev.evaluate(agent, state, eval_index=2)[0] == score
