"""The host-env path of the port against the JAX package: ``PyVecEnv``,
``GymVecBridge`` / ``evaluate_policy_on_gym``, the real-ALE seam,
``HostEnvTrainer`` / ``HostEvaluator``, the n-step stride check, and the
three host gate configs as ``chip_smoke.py`` builds them.

The trainer parity runs both trainers on the same C++ envs with ε 0 and
the JAX agent's initial parameters carried over (``convert``), so both act
greedily on the same observations: the test first holds the actions step
by step, then the replay state, the update bursts and the record keys.
With learning rate 0 the parameters never move and the two runs stay in
lockstep through the updates; on Pong the comparison stops at the first
update, so the JAX side compiles no CNN update.
"""

import importlib.util
import math
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from border_tpu.agents import DQN as JaxDQN
from border_tpu.agents import DQNConfig as JaxDQNConfig
from border_tpu.envs import make as jax_make
from border_tpu.envs.ale import AleVecEnv as JaxAleVecEnv
from border_tpu.envs.ale import ale_available as jax_ale_available
from border_tpu.envs.gym_bridge import evaluate_policy_on_gym as jax_evaluate_on_gym
from border_tpu.envs.native import NativeVecEnv as JaxNativeVecEnv
from border_tpu.envs.py_env import PyVecEnv as JaxPyVecEnv
from border_tpu.errors import ConfigError as JaxConfigError
from border_tpu.models import AtariCNN as JaxAtariCNN
from border_tpu.record.recorder import NullRecorder as JaxNullRecorder
from border_tpu.replay import FrameReplayBuffer as JaxFrameReplayBuffer
from border_tpu.replay import ReplayBuffer as JaxReplayBuffer
from border_tpu.train import HostEnvTrainer as JaxHostEnvTrainer
from border_tpu.train import Trainer as JaxTrainer
from border_tpu.train import TrainerConfig as JaxTrainerConfig
from border_tpu_torch import convert
from border_tpu_torch.agents import DQN, DQNConfig
from border_tpu_torch.envs import AleVecEnv, PyVecEnv, ale_available, make
from border_tpu_torch.envs.gym_bridge import GymVecBridge, evaluate_policy_on_gym
from border_tpu_torch.envs.native import NativeVecEnv
from border_tpu_torch.errors import ConfigError
from border_tpu_torch.models import AtariCNN
from border_tpu_torch.record import NullRecorder
from border_tpu_torch.replay import FrameReplayBuffer, ReplayBuffer
from border_tpu_torch.train import HostEnvTrainer, HostEvaluator, Trainer, TrainerConfig
from border_tpu_torch.utils import CheckpointManager

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Beside other test processes torch's intra-op threads contend for the
    cores; the networks here are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the n-step stride check -------------------------------------------------
def test_nstep_stride_check_matches_the_jax_trainers():
    """An n-step flat buffer whose stride is not the envs per vec step is
    rejected by both Trainers and by the port's HostEnvTrainer."""
    cfg = dict(num_envs=8, batch_size=16)
    with pytest.raises(JaxConfigError, match="stride"):
        JaxTrainer(jax_make("CartPole-v1"), JaxDQN(JaxDQNConfig()),
                   JaxReplayBuffer(1024, n_step=3, stride=1), JaxTrainerConfig(**cfg))
    JaxTrainer(jax_make("CartPole-v1"), JaxDQN(JaxDQNConfig()),
               JaxReplayBuffer(1024, n_step=3, stride=8), JaxTrainerConfig(**cfg))

    def port(cls, env, stride):
        return cls(env, DQN(DQNConfig()),
                   ReplayBuffer(1024, n_step=3, stride=stride, device="cpu"),
                   TrainerConfig(**cfg), device="cpu")

    for cls, env in ((Trainer, make("CartPole-v1")), (HostEnvTrainer, "CartPole-v1")):
        with pytest.raises(ConfigError, match="stride"):
            port(cls, env, 1)
        tr = port(cls, env, 8)
        if cls is HostEnvTrainer:
            tr.env.close()


# -- PyVecEnv, the bridge, NumpyPendulum -----------------------------------
@pytest.mark.parametrize("name", ["CartPole-v1", "Pendulum-v1"])
def test_pyvecenv_matches_the_jax_one_on_real_gymnasium(name):
    n = 4
    ours, ref = PyVecEnv.gym(name, n, seed=3), JaxPyVecEnv.gym(name, n, seed=3)
    assert ours.observation_space.shape == ref.observation_space.shape
    assert ours.observation_space.dtype == torch.float32
    assert ours.obs_dtype == ref.obs_dtype == np.float32
    np.testing.assert_array_equal(ours.reset(), ref.reset())
    rng = np.random.RandomState(1)
    ends = 0
    for _ in range(260):  # past Pendulum's 200-step horizon
        if name == "CartPole-v1":
            act = rng.randint(0, 2, n)
        else:
            act = rng.uniform(-2, 2, (n, 1)).astype(np.float32)
        got, want = ours.step_final(act), ref.step_final(act)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        ends += int((got[3] | got[4]).sum())
    assert ends > 0
    ours.close()
    ref.close()


def test_numpy_pendulum_is_gymnasium_pendulum_bitwise():
    """chip_smoke's numpy Pendulum (the card's machine has no gymnasium)
    against gymnasium's Pendulum-v1, through PyVecEnv."""
    ours = chip_smoke.numpy_pendulum(4, 11)
    ref = PyVecEnv.gym("Pendulum-v1", 4, seed=11)
    assert ours.observation_space == ref.observation_space
    assert ours.action_space == ref.action_space
    np.testing.assert_array_equal(ours.reset(), ref.reset())
    rng = np.random.RandomState(2)
    for _ in range(450):  # two resets with the continued generator
        act = rng.uniform(-3, 3, (4, 1)).astype(np.float32)
        for a, b in zip(ours.step_final(act), ref.step_final(act)):
            np.testing.assert_array_equal(a, b)


def _dict_reach(keys):
    import gymnasium

    class DictReach(gymnasium.Env):
        observation_space = gymnasium.spaces.Dict(
            {k: gymnasium.spaces.Box(-1, 1, (d,), np.float32) for k, d in keys})
        action_space = gymnasium.spaces.Box(-1, 1, (2,), np.float32)

        def reset(self, seed=None, options=None):
            if seed is not None:
                self.rng = np.random.default_rng(seed)
            self.o = {k: self.rng.uniform(-1, 1, d).astype(np.float32)
                      for k, d in keys}
            self.t = 0
            return dict(self.o), {}

        def step(self, a):
            self.t += 1
            self.o = {k: np.clip(v + 0.05 * self.t, -1, 1).astype(np.float32)
                      for k, v in self.o.items()}
            return dict(self.o), -float(self.t), False, self.t >= 5, {}

    return DictReach


@pytest.mark.parametrize("keys, flatten_keys, dim", [
    ((("achieved", 2), ("desired", 2)), None, 4),  # canonical flatten
    ((("achieved_goal", 2), ("desired_goal", 2), ("observation", 4)), None, 6),  # goal env
    ((("achieved_goal", 2), ("desired_goal", 2), ("observation", 4)),
     ("desired_goal", "achieved_goal"), 4),
])
def test_pyvecenv_dict_flatten_matches_the_jax_one(keys, flatten_keys, dim):
    env = _dict_reach(keys)
    ours = PyVecEnv([env] * 3, seed=0, flatten_keys=flatten_keys)
    ref = JaxPyVecEnv([env] * 3, seed=0, flatten_keys=flatten_keys)
    assert ours.observation_space.shape == ref.observation_space.shape == (dim,)
    np.testing.assert_array_equal(ours.reset(), ref.reset())
    for _ in range(8):  # through an auto-reset at step 5
        act = np.zeros((3, 2), np.float32)
        for a, b in zip(ours.step_final(act), ref.step_final(act)):
            np.testing.assert_array_equal(a, b)
    if dim == 6:  # the goal-env default: observation ‖ desired_goal
        obs = ours.step_final(np.zeros((3, 2), np.float32))[0]
        o = ours.envs[0].o
        np.testing.assert_array_equal(
            obs[0], np.concatenate([o["observation"], o["desired_goal"]]))
    with pytest.raises(KeyError, match="flatten_keys"):
        PyVecEnv([env], flatten_keys=("nope",))
    with pytest.raises(KeyError, match="flatten_keys"):
        JaxPyVecEnv([env], flatten_keys=("nope",))


@pytest.mark.parametrize("env_id, discrete", [("CartPole-v1", True),
                                               ("Pendulum-v1", False)])
def test_gym_bridge_scores_a_policy_as_the_jax_one(env_id, discrete):
    if discrete:
        def policy(obs):
            return (obs[:, 2] + 0.3 * obs[:, 3] > 0).astype(np.int64)
    else:
        def policy(obs):
            return np.clip(-2.0 * obs[:, 2:3], -2, 2).astype(np.float32)
    kw = dict(n_episodes=3, max_steps=300, seed=5, discrete=discrete)
    ours = evaluate_policy_on_gym(env_id, policy, **kw)
    assert ours == jax_evaluate_on_gym(env_id, policy, **kw)
    assert math.isfinite(ours) and (ours > 100 if discrete else ours < 0)
    bridge = GymVecBridge(env_id, 2)
    obs = bridge.reset(1)
    assert obs.shape[0] == 2 and obs.dtype == np.float32
    out = bridge.step(policy(obs))
    assert [x.shape[0] for x in out] == [2] * 5
    bridge.close()


# -- the real-ALE seam, through stub modules -----------------------------------
def _stub_ale(monkeypatch, roms):
    """A stub ``ale_py`` whose ROM registry holds ``roms``."""
    mod = types.ModuleType("ale_py")
    registry = types.ModuleType("ale_py.roms")
    registry.get_all_rom_ids = lambda: ["pong", "space_invaders"]
    registry.get_rom_path = lambda rom: (Path(f"/roms/{rom}.bin")
                                         if rom in roms else None)
    mod.roms = registry
    monkeypatch.setitem(sys.modules, "ale_py", mod)
    monkeypatch.setitem(sys.modules, "ale_py.roms", registry)


def test_ale_available_checks_for_a_rom(monkeypatch):
    monkeypatch.setitem(sys.modules, "ale_py", None)  # not installed
    assert not ale_available() and not jax_ale_available()
    _stub_ale(monkeypatch, roms=())
    # the JAX check only tries the imports
    assert jax_ale_available()
    assert not ale_available() and not ale_available("ALE/Pong-v5")
    _stub_ale(monkeypatch, roms=("space_invaders",))
    assert ale_available() and ale_available("ALE/SpaceInvaders-v5")
    assert ale_available("SpaceInvadersNoFrameskip-v4")
    assert not ale_available("ALE/Pong-v5")


class _FakeAtari:
    """Stands in for ``AtariPreprocessing(gymnasium.make(...))``: 84×84
    frames from a seeded generator, a life lost every 7 steps in train
    mode, a game of 11 steps."""

    def __init__(self, env, terminal_on_life_loss, **kw):
        import gymnasium

        self.train = terminal_on_life_loss
        self.action_space = gymnasium.spaces.Discrete(6)

    def reset(self, seed=None, options=None):
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.t = 0
        return self.rng.integers(0, 256, (84, 84), dtype=np.uint8), {}

    def step(self, a):
        self.t += 1
        frame = self.rng.integers(0, 256, (84, 84), dtype=np.uint8) // (a + 1)
        term = self.t >= 11 or (self.train and self.t % 7 == 0)
        return frame, float(self.rng.integers(-3, 4)), term, False, {}

    def close(self):
        pass


@pytest.mark.parametrize("train", [True, False])
def test_ale_vec_env_matches_the_jax_seam_on_a_stub(monkeypatch, train):
    import gymnasium
    import gymnasium.wrappers

    monkeypatch.setattr(gymnasium, "make", lambda *a, **k: None)
    monkeypatch.setattr(gymnasium.wrappers, "AtariPreprocessing", _FakeAtari)
    ours = AleVecEnv("ALE/Pong-v5", 3, seed=4, train=train, n_threads=1)
    ref = JaxAleVecEnv("ALE/Pong-v5", 3, seed=4, train=train, n_threads=1)
    assert ours.observation_space.shape == (84, 84, 4)
    assert ours.observation_space.dtype == torch.uint8
    assert ours.action_space.n == 6
    obs = ours.reset()
    np.testing.assert_array_equal(obs, ref.reset())
    assert (obs[..., 0] == obs[..., 3]).all()
    for i in range(25):
        act = np.full(3, i % 6)
        got, want = ours.step_final(act), ref.step_final(act)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        if train:
            assert set(np.unique(got[2])) <= {-1.0, 0.0, 1.0}
    ours.close()


# -- HostEnvTrainer against the JAX one ---------------------------------------
def _recording(cls):
    class Recording(cls):
        """Keeps each step's actions and the observations handed out."""

        def reset(self):
            obs = super().reset()
            self.log = [obs]
            self.acts, self.steps = [], []
            return obs

        def step_final(self, actions):
            self.acts.append(np.array(actions))
            out = super().step_final(actions)
            self.steps.append(out)
            self.log.append(out[0])
            return out

    return Recording


class _JaxKeep(JaxNullRecorder):
    def __init__(self):
        super().__init__()
        self.kept = []

    def store(self, record):
        self.kept.append(dict(record.items()))


class _Keep(NullRecorder):
    def __init__(self):
        super().__init__()
        self.kept = []

    def store(self, record):
        self.kept.append(dict(record.items()))


def _pair(env_name, n, cfg, jax_model=None, port_model=None, lr=0.0, frame=False):
    """A JAX and a port HostEnvTrainer on recording native envs, greedy
    (ε 0), the port's agent started from the JAX agent's initial state."""
    kw = dict(lr=lr, eps_start=0.0, eps_final=0.0, double_dqn=True)
    jagent = JaxDQN(JaxDQNConfig(**kw, **({"model": jax_model} if jax_model else
                                          {"hidden": (16, 16)})))
    agent = DQN(DQNConfig(**kw, **({"model": port_model} if port_model else
                                   {"hidden": (16, 16)})))
    jenv = _recording(JaxNativeVecEnv)(env_name, n, seed=cfg["seed"])
    env = _recording(NativeVecEnv)(env_name, n, seed=cfg["seed"])
    if frame:
        jbuf = JaxFrameReplayBuffer(capacity=cfg["capacity"], num_envs=n)
        buf = FrameReplayBuffer(capacity=cfg["capacity"], num_envs=n, device="cpu")
    else:
        jbuf, buf = JaxReplayBuffer(2048), ReplayBuffer(2048, device="cpu")
    tc = {k: v for k, v in cfg.items() if k != "capacity"}
    jrec, rec = _JaxKeep(), _Keep()
    jtr = JaxHostEnvTrainer(jenv, jagent, jbuf, JaxTrainerConfig(**tc), recorder=jrec)
    tr = HostEnvTrainer(env, agent, buf, TrainerConfig(**tc), recorder=rec,
                        device="cpu")
    ja = jagent.init(jax.random.split(jax.random.PRNGKey(cfg["seed"]))[0],
                     jtr.observation_space, jtr.action_space)
    ta = convert.dqn_state(agent, ja, tr.observation_space, tr.action_space,
                           device="cpu")
    agent.init = lambda *a, **k: ta
    bursts = {"jax": [], "port": []}
    for key, t in (("jax", jtr), ("port", tr)):
        orig = t._update_burst
        t._update_burst = (lambda orig, log: lambda a, b, k, m: (
            log.append(m), orig(a, b, k, m))[1])(orig, bursts[key])
    return jtr, tr, jrec, rec, bursts


def _record_keys(kept):
    return [sorted(k for k in r if k != "samples_per_sec" and k != "host_wait_frac")
            for r in kept]


@pytest.mark.parametrize("n, opt_interval, max_opts", [
    (8, 4, 24),  # 2 updates an iteration
    (32, 64, 6),  # half an update an iteration: the debt carries it
])
def test_host_trainer_matches_the_jax_one_on_cartpole(n, opt_interval, max_opts):
    cfg = dict(max_opts=max_opts, warmup_period=64, opt_interval=opt_interval,
               batch_size=16, num_envs=n, steps_per_chunk=4,
               eval_interval=10**9, seed=2)
    jtr, tr, jrec, rec, bursts = _pair("CartPole-v1", n, cfg)
    jr = jtr.train()
    r = tr.train()
    # the same greedy actions at every step, hence the same env steps
    assert len(tr.env.acts) == len(jtr.env.acts) > 10
    for i, (a, b) in enumerate(zip(tr.env.acts, jtr.env.acts)):
        np.testing.assert_array_equal(a, b, err_msg=f"step {i}")
    assert sum(int((s[3] | s[4]).sum()) for s in tr.env.steps) > 0  # episodes ended
    assert bursts["port"] == bursts["jax"]
    assert set(bursts["port"]) == ({2} if n == 8 else {1})
    assert (r.env_steps, r.opt_steps) == (jr.env_steps, int(jr.opt_steps))
    # the replay: transitions, cursor and fill
    js = convert.replay_state(jr.buffer_state, device="cpu")
    for f in ("obs", "act", "next_obs", "reward", "terminated", "truncated"):
        assert torch.equal(getattr(r.buffer_state.data, f), getattr(js.data, f)), f
    assert (r.buffer_state.cursor, r.buffer_state.size) == (js.cursor, js.size)
    # the records at chunk cadence: the same keys and env-step trajectory
    assert _record_keys(rec.kept) == _record_keys(jrec.kept)
    assert [k["env_steps"] for k in rec.kept] == [k["env_steps"] for k in jrec.kept]
    assert all(0.0 <= k["host_wait_frac"] <= 1.0 for k in rec.kept)


def _frame_pair(env_name, n, lr):
    f32 = dict(jax_model=lambda a: JaxAtariCNN(a, dtype=jnp.float32),
               port_model=lambda a: AtariCNN(a, dtype=torch.float32))
    # the first update comes at iteration 40 and ends both runs
    cfg = dict(max_opts=1, warmup_period=35 * n, opt_interval=n, batch_size=8,
               num_envs=n, steps_per_chunk=8, eval_interval=10**9, seed=1,
               capacity=64)
    return _pair(env_name, n, cfg, lr=lr, frame=True, **f32)


def test_host_trainer_fills_the_frame_ring_as_the_jax_one_on_pong():
    n = 8
    jtr, tr, _, _, bursts = _frame_pair("Pong-v0", n, lr=1e-4)

    def counted(a, b, k, m):  # the JAX side stops at its first burst
        bursts["jax"].append(m)
        return a.replace(n_opts=a.n_opts + m), b, {}

    jtr._update_burst = counted
    seen = []
    select = tr._select
    tr._select = lambda a, obs, g: (seen.append(obs.clone()), select(a, obs, g))[1]
    jr = jtr.train()
    r = tr.train()
    # 41 iterations, the last with the burst, push 41 transitions; the
    # feeder steps the 42nd actions (chosen after the port's one update)
    # before it closes
    assert len(tr.env.acts) == len(jtr.env.acts) == 42
    for i, (a, b) in enumerate(zip(tr.env.acts[:41], jtr.env.acts)):
        np.testing.assert_array_equal(a, b, err_msg=f"step {i}")
    assert len({int(a) for acts in tr.env.acts for a in acts}) > 1
    assert bursts["port"] == bursts["jax"] == [1]
    js = convert.frame_replay_state(jr.buffer_state, device="cpu")
    for f in ("frames", "act", "reward", "terminated", "truncated", "age"):
        assert torch.equal(getattr(r.buffer_state, f), getattr(js, f)), f
    assert r.buffer_state.total == js.total == 41
    # Pong has no lives: the device stack ring is the host's obs bitwise
    assert len(seen) + 1 == len(tr.env.log) == 43
    for i, (dev_obs, host_obs) in enumerate(zip(seen, tr.env.log)):
        np.testing.assert_array_equal(dev_obs.numpy(), host_obs, err_msg=f"step {i}")


def test_breakout_life_loss_restarts_the_device_ring_not_the_host_stack():
    """Seen in the reference and kept: in train mode the C++ Breakout ends
    the learning episode at a life loss but its stack goes on, while the
    device ring restarts as the new frame repeated."""
    n = 8
    env = _recording(NativeVecEnv)("Breakout-v0", n, seed=5)
    agent = DQN(DQNConfig(model=lambda a: AtariCNN(a, dtype=torch.float32),
                          eps_start=1.0, eps_final=1.0))
    cfg = TrainerConfig(max_opts=1, warmup_period=(150 - 5) * n, opt_interval=n,
                        batch_size=8, num_envs=n, steps_per_chunk=16, seed=0)
    tr = HostEnvTrainer(env, agent, FrameReplayBuffer(256, n, device="cpu"), cfg,
                        device="cpu")
    seen = []
    select = tr._select
    tr._select = lambda a, obs, g: (seen.append(obs.clone()), select(a, obs, g))[1]
    tr.train()
    dev = torch.stack(seen).numpy()  # [T, n, 84, 84, 4], T iterations + prime
    t_end = len(dev)
    host = np.stack(env.log)[:t_end]
    term = np.stack([np.zeros(n, bool)] + [s[3] for s in env.steps])[:t_end]
    trunc = np.stack([np.zeros(n, bool)] + [s[4] for s in env.steps])[:t_end]
    assert not trunc.any()
    # a life loss: terminated, and the host's stack goes on with the game
    lost = term & np.array([[t > 0 and not (host[t][e, ..., :3] == host[t][e, ..., 3:4]).all()
                             for e in range(n)] for t in range(len(host))])
    assert lost.sum() > 0
    differs = (dev != host).reshape(len(host), n, -1).any(-1)
    assert differs.any()
    for t, e in zip(*np.nonzero(differs)):
        # only within the 3 steps after a life loss, where the device ring
        # holds the first frame after it repeated
        back = [s for s in range(max(t - 3, 0), t + 1) if lost[s, e]]
        assert back, (t, e)
        first = host[back[-1]][e, ..., 3]
        np.testing.assert_array_equal(dev[back[-1]][e], np.repeat(first[..., None], 4, -1))
        np.testing.assert_array_equal(dev[t][e, ..., 3], host[t][e, ..., 3])
    assert not differs[~(lost | np.roll(lost, 1, 0) | np.roll(lost, 2, 0)
                         | np.roll(lost, 3, 0))].any()


# -- resume and evaluation -------------------------------------------------------
class _Indexed:
    def __init__(self, inner):
        self.inner, self.indices = inner, []

    def evaluate(self, agent, agent_state, eval_index=0):
        self.indices.append(eval_index)
        return self.inner.evaluate(agent, agent_state, eval_index=eval_index)


def test_resume_continues_counters_replay_and_evaluation_count(tmp_path):
    cfg = TrainerConfig(max_opts=24, warmup_period=64, opt_interval=8,
                        batch_size=32, num_envs=8, steps_per_chunk=8,
                        eval_interval=8, seed=4)

    def build(max_opts, mgr=None):
        ev = _Indexed(HostEvaluator("CartPole-v1", n_episodes=2, max_steps=20))
        return HostEnvTrainer(
            "CartPole-v1", DQN(DQNConfig(hidden=(8,))), ReplayBuffer(512, device="cpu"),
            cfg.replace(max_opts=max_opts), evaluator=ev, checkpoint_manager=mgr,
            checkpoint_interval=8 if mgr else 0, device="cpu"), ev

    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=3, device="cpu")
    t1, ev1 = build(24, mgr)
    r1 = t1.train()
    assert mgr.all_steps() == [8, 16, 24] and ev1.indices == [0, 1, 2]

    restore, restored = mgr.restore, []

    def check(*a, **kw):  # the replay right after the restore is the saved one
        out = restore(*a, **kw)
        st = out["buffer_state"]
        assert (st.cursor, st.size) == (r1.buffer_state.cursor, r1.buffer_state.size)
        for f in ("obs", "act", "next_obs", "reward", "terminated", "truncated"):
            assert torch.equal(getattr(st.data, f), getattr(r1.buffer_state.data, f))
        restored.append(out["extra"])
        return out

    mgr.restore = check
    t2, ev2 = build(40, None)
    r2 = t2.train(resume_from=mgr)
    assert restored[0]["n_evals"] == 2 and restored[0]["opt_steps"] == 24
    # the evaluation at step 24 came after the checkpoint: the resumed run
    # makes it again with the same index, then goes on
    assert ev2.indices == [2, 3, 4]
    assert r2.opt_steps == 40 and r2.agent_state.n_opts == 40
    iters = (40 - 24) * cfg.opt_interval // cfg.num_envs
    assert r2.env_steps == r1.env_steps + iters * cfg.num_envs
    assert r2.buffer_state.size == min(512, r1.buffer_state.size + iters * 8)
    assert r2.agent_state.n_samples == r1.agent_state.n_samples + iters * 8


def test_host_evaluator_pixel_eval_mode():
    agent = DQN(DQNConfig(model=lambda a: AtariCNN(a, dtype=torch.float32)))
    env = NativeVecEnv("Pong-v0", 2, seed=0, train=False)
    state = agent.init(0, env.observation_space, env.action_space, device="cpu")
    env.close()
    ev = HostEvaluator("Pong-v0", n_episodes=2, max_steps=30)
    score, rec = ev.evaluate(agent, state)
    assert math.isfinite(score)
    assert rec["Episodes truncated"] == 2.0  # 30 steps cannot finish Pong
    assert ev.evaluate(agent, state)[0] == score  # seeded


# -- the host gate configs --------------------------------------------------------
def _learning():
    spec = importlib.util.spec_from_file_location(
        "learning_gate", ROOT / "benchmarks" / "learning.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["pong_host", "breakout_host", "pendulum_host"])
def test_host_gate_configs_build_as_the_jax_ones_and_train(name, monkeypatch):
    """At full width ``chip_smoke.host_config`` gives the JAX config's
    trainer settings, buffer, agent and evaluator; at reduced width it
    trains two updates and evaluates once on the CPU, the pixel ones
    sampling through ``gather_frames``."""
    from border_tpu_torch.ops import frame_gather

    jenv, jagent, jbuf, jcfg, jev, _ = _learning()._build(name, 0)
    env, agent, buf, cfg, ev = chip_smoke.host_config(name, "cpu")
    for f in ("max_opts", "warmup_period", "opt_interval", "batch_size",
              "num_envs", "steps_per_chunk", "eval_interval", "seed"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert (ev.n_episodes, ev.max_steps) == (jev.n_episodes, jev.max_steps)
    assert buf.capacity == jbuf.capacity and type(buf).__name__ == type(jbuf).__name__
    for f in ("lr", "double_dqn", "soft_update_interval", "tau", "eps_final_step",
              "actor_hidden", "critic_hidden", "n_critics", "actor_lr",
              "critic_lr", "ent_coef_mode"):
        if hasattr(jagent.config, f):
            assert getattr(agent.config, f) == getattr(jagent.config, f), f
    if isinstance(jenv, str):
        assert env == jenv
    else:
        jenv.close()
        env.close()

    calls = []
    monkeypatch.setattr(
        "border_tpu_torch.replay.frame_buffer.gather_frames",
        lambda frames, idx: calls.append(tuple(idx.shape))
        or frame_gather.gather_frames_ref(frames, idx))
    width = 4
    env, agent, buf, cfg, ev = chip_smoke.host_config(
        name, "cpu", capacity=256, eval_steps=6, num_envs=width,
        warmup_period=12 * width, opt_interval=width, batch_size=8, max_opts=2,
        eval_interval=2, steps_per_chunk=4)
    tr = HostEnvTrainer(env, agent, buf, cfg, evaluator=ev, device="cpu")
    r = tr.train()
    assert r.opt_steps == 2 and len(r.eval_history) == 1
    assert math.isfinite(r.eval_history[0][1])
    assert calls == ([] if name == "pendulum_host" else [(8, 5)] * 2)
