"""The decoupled actor-learner (``train/async_trainer.py``) and
``Agent.sync_policy``.

- With ``sync_interval`` at most a chunk's updates the actor always acts on
  the last chunk's final parameters, so the run equals the port's
  ``Trainer`` bitwise on the same seed.
- With a huge ``sync_interval`` the actor acts on the initial parameters
  throughout while the learner's move: a copy, not the live module.
- The sync schedule is the JAX ``AsyncTrainer``'s; a resumed run equals the
  uninterrupted one bitwise, stale actor parameters included.
- A checkpoint with a module in ``extra`` and no env state round-trips.
"""

import numpy as np
import pytest
import torch

from border_tpu.agents import DQN as JaxDQN
from border_tpu.agents import DQNConfig as JaxDQNConfig
from border_tpu.envs import make as jax_make
from border_tpu.replay import ReplayBuffer as JaxReplayBuffer
from border_tpu.train import AsyncTrainer as JaxAsyncTrainer
from border_tpu.train import TrainerConfig as JaxTrainerConfig
from border_tpu_torch.agents import (AWAC, BC, DQN, IQL, IQN, SAC, AWACConfig,
                                     BCConfig, DQNConfig, IQLConfig, IQNConfig,
                                     SACConfig)
from border_tpu_torch.envs import make
from border_tpu_torch.models import AtariCNN
from border_tpu_torch.replay import FrameReplayBuffer, ReplayBuffer, Transition
from border_tpu_torch.train import AsyncTrainer, Evaluator, Trainer, TrainerConfig
from border_tpu_torch.train.trainer import example_transition
from border_tpu_torch.utils import CheckpointManager
from border_tpu_torch.utils.checkpoint import pack_state

CFG = dict(warmup_period=64, opt_interval=16, batch_size=16, num_envs=8,
           steps_per_chunk=8, eval_interval=10**9, seed=3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _assert_equal(a, b):
    x, y = dict(_leaves(pack_state(a))), dict(_leaves(pack_state(b)))
    assert x.keys() == y.keys()
    for k in x:
        if torch.is_tensor(x[k]):
            assert torch.equal(x[k], y[k]), k
        else:
            assert x[k] == y[k], k


def _build(cls, kind, manager=None, interval=0, **cfg):
    if kind == "cartpole":
        env = make("CartPole-v1")
        agent = DQN(DQNConfig(hidden=(16,), eps_final_step=256))
        buf = ReplayBuffer(512, device="cpu")
        evaluator = Evaluator(env, n_episodes=2, max_steps=50, device="cpu")
    else:
        env = make("Pong-v0")
        agent = DQN(DQNConfig(model=lambda a: AtariCNN(a, dtype=torch.float32),
                              lr=1e-3, eps_final_step=64))
        buf = FrameReplayBuffer(capacity=32, num_envs=4, device="cpu")
        evaluator = None
        cfg = dict(dict(num_envs=4, warmup_period=32, opt_interval=8, batch_size=8),
                   **cfg)
    return cls(env, agent, buf, TrainerConfig(**{**CFG, **cfg}),
               evaluator=evaluator, checkpoint_manager=manager,
               checkpoint_interval=interval, device="cpu")


@pytest.mark.parametrize("kind", ["cartpole", "pong"])
def test_short_sync_interval_equals_the_trainer_bitwise(kind):
    cfg = dict(max_opts=24, eval_interval=8, sync_interval=4)
    a = _build(Trainer, kind, **cfg).train()
    b = _build(AsyncTrainer, kind, **cfg).train()
    assert a.opt_steps == b.opt_steps == 24
    assert a.eval_history == b.eval_history
    _assert_equal(a.agent_state, b.agent_state)
    _assert_equal(a.buffer_state, b.buffer_state)


def test_long_sync_interval_acts_on_the_initial_parameters():
    tr = _build(AsyncTrainer, "cartpole", max_opts=24, sync_interval=10**9)
    agent = tr.agent
    agent.config = DQNConfig(hidden=(16,), eps_start=0.0, eps_final=0.0)
    initial = agent.init(CFG["seed"], tr.vec.observation_space,
                         tr.vec.action_space, device="cpu").params
    acted = []
    select = agent.select_action

    def recording(state, obs, gen):
        act = select(state, obs, gen)
        acted.append((state.params, obs.clone(), act.clone()))
        return act

    agent.select_action = recording
    r = tr.train()
    learner = r.agent_state.params
    # one warmup chunk, then 6 chunks of 4 updates
    assert len(acted) == 7 * CFG["steps_per_chunk"] and r.opt_steps == 24
    # the learner moved; the actor never saw it
    assert not all(torch.equal(p, q) for p, q in
                   zip(learner.parameters(), initial.parameters()))
    for module, obs, act in acted:
        assert module is tr._actor_params and module is not learner
        for p, q in zip(module.parameters(), initial.parameters()):
            assert torch.equal(p, q)
        with torch.no_grad():
            assert torch.equal(act, initial(obs).argmax(-1).to(act.dtype))
    # the actor phase's env-step counts were carried onto the learner
    assert r.agent_state.n_samples == r.env_steps
    assert tr._last_sync == 0


def test_sync_schedule_matches_the_jax_async_trainer():
    cfg = dict(CFG, max_opts=30, sync_interval=7, num_envs=4, steps_per_chunk=4,
               opt_interval=4)

    class JaxRecording(JaxAsyncTrainer):
        syncs = ()

        def _dispatch(self, *a, **kw):
            out = super()._dispatch(*a, **kw)
            if not self.syncs or self.syncs[-1] != self._last_sync:
                self.syncs += (self._last_sync,)
            return out

    class Recording(AsyncTrainer):
        syncs = ()

        def _sync(self, policy, n_opts):
            super()._sync(policy, n_opts)
            self.syncs += (n_opts,)

    jtr = JaxRecording(jax_make("CartPole-v1"), JaxDQN(JaxDQNConfig(hidden=(8,))),
                       JaxReplayBuffer(512), JaxTrainerConfig(**cfg))
    tr = Recording(make("CartPole-v1"), DQN(DQNConfig(hidden=(8,))),
                   ReplayBuffer(512, device="cpu"), TrainerConfig(**cfg),
                   device="cpu")
    jr, r = jtr.train(), tr.train()
    assert int(jr.opt_steps) == r.opt_steps == 32
    assert tr.syncs == jtr.syncs == (0, 8, 16, 24, 32)


def test_resumed_async_run_equals_the_uninterrupted_one_bitwise(tmp_path):
    """Checkpoints at 8 and 16 updates; the last sync before 16 was at 12,
    so the resumed run's actor must come back stale from the checkpoint."""
    cfg = dict(max_opts=20, sync_interval=10, opt_interval=16)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=5, device="cpu")
    whole = _build(AsyncTrainer, "cartpole", mgr, 8, **cfg)
    res_full = whole.train()
    assert mgr.all_steps() == [8, 16] and res_full.opt_steps == 20
    resumed = _build(AsyncTrainer, "cartpole", **cfg)
    res = resumed.train(resume_from=mgr)
    assert (res.opt_steps, res.env_steps) == (res_full.opt_steps, res_full.env_steps)
    _assert_equal(res_full.agent_state, res.agent_state)
    _assert_equal(res_full.buffer_state, res.buffer_state)
    assert resumed._last_sync == whole._last_sync == 12
    _assert_equal(whole._actor_params, resumed._actor_params)
    assert not all(torch.equal(p, q) for p, q in zip(
        resumed._actor_params.parameters(), res.agent_state.params.parameters()))


def test_checkpoint_round_trips_a_module_in_extra_and_no_env_state(tmp_path):
    agent = SAC(SACConfig(actor_hidden=(8,), critic_hidden=(8,)))
    env = make("Pendulum-v1")
    obs, act = (env.observation_space(env.default_params),
                env.action_space(env.default_params))
    state = agent.init(0, obs, act, device="cpu")
    actor = state.actor_params
    buf = ReplayBuffer(16, device="cpu")
    example = example_transition(obs, act, "cpu")
    bstate = buf.push(buf.init(example), Transition(
        obs=torch.randn(5, 3), act=torch.randn(5, 1), next_obs=torch.randn(5, 3),
        reward=torch.randn(5), terminated=torch.rand(5) < 0.5,
        truncated=torch.zeros(5, dtype=torch.bool)))
    gen = torch.Generator().manual_seed(5)
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    mgr.save(3, state, bstate, key=gen, extra={"actor_params": actor, "last_sync": 2})
    fresh = agent.init(1, obs, act, device="cpu")
    out = mgr.restore(fresh, buf.init(example), key=torch.Generator())
    assert out["vec_state"] is None and out["extra"]["last_sync"] == 2
    saved = out["extra"]["actor_params"]
    assert saved.keys() == actor.state_dict().keys()
    for k, v in actor.state_dict().items():
        assert torch.equal(saved[k], v)
    _assert_equal(out["agent_state"], state)
    _assert_equal(out["buffer_state"], bstate)
    assert torch.equal(out["key"].get_state(), gen.get_state())


@pytest.mark.parametrize("name", ["dqn", "iqn", "sac", "awac", "iql", "bc"])
def test_sync_policy_round_trips(name):
    cart, reacher = make("CartPole-v1"), make("ReacherFlat-v0")
    agent, env = {
        "dqn": (DQN(DQNConfig(hidden=(8,))), cart),
        "iqn": (IQN(IQNConfig(hidden=(8,), feature_dim=8, n_cos=4)), cart),
        "sac": (SAC(SACConfig(actor_hidden=(8,), critic_hidden=(8,))), reacher),
        "awac": (AWAC(AWACConfig(actor_hidden=(8,), critic_hidden=(8,))), reacher),
        "iql": (IQL(IQLConfig()), reacher),
        "bc": (BC(BCConfig(hidden=(8,))), reacher),
    }[name]
    p = env.default_params
    state = agent.init(0, env.observation_space(p), env.action_space(p), device="cpu")
    own = agent.policy_params(state)
    other = agent.policy_params(agent.init(1, env.observation_space(p),
                                           env.action_space(p), device="cpu"))
    synced = agent.sync_policy(state, other)
    assert agent.policy_params(synced) is other
    assert agent.policy_params(state) is own  # the source state is untouched
    # every other field is shared; the counters are the synced state's own
    for f in vars(state):
        if getattr(state, f) is own:
            continue
        assert getattr(synced, f) is getattr(state, f) or getattr(synced, f) == getattr(state, f)
    agent.on_env_step(synced, 7)
    assert synced.n_samples == state.n_samples + 7
    back = agent.sync_policy(synced, own)
    assert agent.policy_params(back) is own and back.n_samples == synced.n_samples
    obs = torch.as_tensor(np.random.RandomState(0).randn(
        3, env.observation_space(p).flat_dim).astype(np.float32))
    torch.testing.assert_close(agent.select_action_eval(back, obs),
                               agent.select_action_eval(state, obs))
