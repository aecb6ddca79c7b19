"""The port's main path as a whole vs the JAX Trainer, plus a CPU smoke of
``Trainer.train()`` and the TrainerConfig contract.

The slice test carries the JAX Trainer's initial agent, env and buffer
states across with ``convert``, then runs both trainers' own loop bodies:

- ``_env_scan`` for K greedy env steps.  K is short enough that no point
  is scored and no episode ends, so no random draw is used (the threefry
  and torch streams cannot match).  Everything is then compared bitwise:
  float32 Pong, the same greedy actions, copied frames.
- one ``_update_scan`` iteration, with the replay draws the JAX trainer
  makes for its key injected into the port's buffer.  Loss agrees to
  rtol 1e-4 (float32 convolutions summed in another order); new params
  are held as in ``test_torch_dqn.py``: Adam's first step is about
  ``lr·sign(g)``, so elements agree to 1e-3·lr except a sliver of
  near-zero grads, and every element is within lr.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from border_tpu.agents import DQN as JaxDQN
from border_tpu.agents import DQNConfig as JaxDQNConfig
from border_tpu.envs import make as jax_make
from border_tpu.models import AtariCNN as JaxAtariCNN
from border_tpu.replay import FrameReplayBuffer as JaxFrameReplayBuffer
from border_tpu.train import Trainer as JaxTrainer
from border_tpu.train import TrainerConfig as JaxTrainerConfig
from border_tpu_torch import convert
from border_tpu_torch.agents import DQN, DQNConfig
from border_tpu_torch.envs import make
from border_tpu_torch.errors import ConfigError
from border_tpu_torch.models import AtariCNN
from border_tpu_torch.ops import frame_gather
from border_tpu_torch.record import BufferedRecorder
from border_tpu_torch.replay import FrameReplayBuffer
from border_tpu_torch.train import Trainer, TrainerConfig

N, K, B, CAP, LR = 4, 8, 8, 16, 1e-4
AGENT_KW = dict(lr=LR, double_dqn=True, soft_update_interval=2_000, tau=1.0)


def _trainers():
    cfg = dict(num_envs=N, steps_per_chunk=K, batch_size=B, opt_interval=K * N,
               warmup_period=0)
    jtr = JaxTrainer(
        jax_make("Pong-v0"),
        JaxDQN(JaxDQNConfig(model=lambda n: JaxAtariCNN(n, dtype=jnp.float32),
                            **AGENT_KW)),
        JaxFrameReplayBuffer(capacity=CAP, num_envs=N),
        JaxTrainerConfig(**cfg),
    )
    ttr = Trainer(
        make("Pong-v0"),
        DQN(DQNConfig(model=lambda n: AtariCNN(n, dtype=torch.float32),
                      **AGENT_KW)),
        FrameReplayBuffer(capacity=CAP, num_envs=N, device="cpu"),
        TrainerConfig(**cfg),
        device="cpu",
    )
    assert jtr.updates_per_chunk == ttr.updates_per_chunk == 1
    return jtr, ttr


def _carry(jtr, ttr, ja, jv, jb):
    ta = convert.dqn_state(ttr.agent, ja, ttr.vec.observation_space,
                           ttr.vec.action_space, device="cpu")
    tv = convert.vec_env_state(jv, seed_or_gen=0)
    tb = convert.frame_replay_state(jb)
    return ta, tv, tb


def _assert_buffers_equal(tb, jb):
    carried = convert.frame_replay_state(jb)
    for name in ("frames", "act", "reward", "terminated", "truncated", "age"):
        assert torch.equal(getattr(tb, name), getattr(carried, name)), name
    assert tb.total == carried.total


def test_env_scan_then_update_matches_jax_trainer(monkeypatch):
    jtr, ttr = _trainers()
    ja, jv, jb = jtr.init_states(jax.random.PRNGKey(0), jax.random.PRNGKey(1))
    ta, tv, tb = _carry(jtr, ttr, ja, jv, jb)

    # -- K greedy env steps: act → step → push --------------------------
    ja, jv, jb, jret, jcnt = jax.jit(
        lambda a, v, b, k: jtr._env_scan(a, v, b, k, explore=False)
    )(ja, jv, jb, jax.random.PRNGKey(2))
    ta, tv, tb, tret, tcnt = ttr._env_scan(
        ta, tv, tb, torch.Generator().manual_seed(2), explore=False
    )
    # the parity case holds: nothing scored, no episode ended
    assert float(jcnt) == tcnt.item() == 0.0
    assert float(jret) == tret.item() == 0.0
    assert not np.asarray(jv.env_state.game.score_agent).any()
    assert not np.asarray(jv.env_state.game.score_opp).any()
    np.testing.assert_array_equal(tv.obs.numpy(), np.asarray(jv.obs))
    for name in ("episode_return", "episode_length", "last_return",
                 "last_length"):
        np.testing.assert_array_equal(getattr(tv, name).numpy(),
                                      np.asarray(getattr(jv, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tv.env_state.game.agent_y.numpy(),
                                  np.asarray(jv.env_state.game.agent_y))
    _assert_buffers_equal(tb, jb)
    assert ta.n_samples == int(ja.n_samples) == K * N
    # the greedy policy moved the paddles: the actions were not all NOOP
    assert len(np.unique(tb.act[:, :K].numpy())) > 1

    # -- one update with the JAX trainer's draws injected ----------------
    key = jax.random.PRNGKey(3)
    k_sample = jax.random.split(jax.random.split(key, 2)[1])[0]
    size = min(tb.total, CAP)
    k_e, k_s = jax.random.split(k_sample)
    e = jax.random.randint(k_e, (B,), 0, N)
    s = jax.random.randint(k_s, (B,), tb.total - size + 4, tb.total - 1)
    draws = (torch.from_numpy(np.asarray(e, np.int64)),
             torch.from_numpy(np.asarray(s, np.int64)))
    monkeypatch.setattr(ttr.buffer, "draw", lambda state, gen, b: draws)

    old = {k: v.clone() for k, v in ta.params.state_dict().items()}
    ja, jb, jm = jax.jit(jtr._update_scan)(ja, jb, key)
    ta, tb, tm = ttr._update_scan(ta, tb, torch.Generator().manual_seed(3))
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(tm["q_mean"].item(), float(jm["q_mean"]),
                               rtol=1e-4, atol=1e-6)
    assert ta.n_opts == int(ja.n_opts) == 1
    want = convert.atari_cnn_state_dict(ja.params)
    for k, p in ta.params.state_dict().items():
        diff = (p - want[k]).abs()
        assert diff.max().item() <= LR + 1e-6, k
        assert (diff > 1e-3 * LR).float().mean().item() <= 0.01, k
        assert not torch.equal(p, old[k]) or (p == 0).all(), k
    _assert_buffers_equal(tb, jb)


def test_train_cpu_smoke():
    """``Trainer.train()`` at a tiny config: a warmup chunk, then update
    chunks until max_opts; finite metrics, records written, no kernel
    launch (the ring is on the CPU)."""
    launches = frame_gather.gather_frames.launches
    cfg = TrainerConfig(num_envs=8, steps_per_chunk=8, batch_size=16,
                        opt_interval=16, warmup_period=0, max_opts=12,
                        flush_record_interval=1, record_compute_cost_interval=4,
                        record_agent_info_interval=8)
    rec = BufferedRecorder()
    agent = DQN(DQNConfig(model=lambda n: AtariCNN(n, dtype=torch.float32),
                          lr=1e-4, double_dqn=True, soft_update_interval=2,
                          tau=1.0))
    tr = Trainer(make("Pong-v0"), agent,
                 FrameReplayBuffer(capacity=32, num_envs=8, device="cpu"),
                 cfg, recorder=rec, device="cpu")
    assert tr.updates_per_chunk == 4
    r = tr.train()
    assert r.opt_steps == 12 and r.agent_state.n_opts == 12
    assert r.env_steps == 4 * 8 * 8  # one warmup chunk + three update chunks
    assert r.buffer_state.total == 32
    assert math.isfinite(r.samples_per_sec) and r.opt_per_sec > 0
    losses = rec.scalars("loss")
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert all(math.isfinite(x) for x in rec.scalars("q_mean"))
    assert rec.scalars("average_opt_time") and rec.scalars("average_sample_time")
    assert any(k.startswith("param/") for r_ in rec.records for k in r_.keys())
    assert frame_gather.gather_frames.launches == launches


def test_config_yaml_round_trip_and_unported_knobs(tmp_path):
    cfg = TrainerConfig(num_envs=1024, steps_per_chunk=32, batch_size=512,
                        opt_interval=64, update_scan_unroll=4)
    cfg.save(str(tmp_path / "c.yaml"))
    assert TrainerConfig.load(str(tmp_path / "c.yaml")) == cfg
    # a YAML written by the JAX TrainerConfig loads in the port
    JaxTrainerConfig(num_envs=16, prefetch_sample=True).save(
        str(tmp_path / "j.yaml"))
    assert TrainerConfig.load(str(tmp_path / "j.yaml")).prefetch_sample

    def trainer(**kw):
        return Trainer(make("Pong-v0"), DQN(DQNConfig(model=AtariCNN)),
                       FrameReplayBuffer(8, 2, device="cpu"),
                       TrainerConfig(num_envs=2).replace(**kw), device="cpu")

    trainer()  # the defaults are accepted
    for kw in (dict(prefetch_sample=True), dict(updates_per_sample_batch=2),
               dict(save_interval=10)):
        with pytest.raises(ConfigError):
            trainer(**kw)
    with pytest.raises(ConfigError, match="A.7"):
        Trainer(make("Pong-v0"), DQN(DQNConfig(model=AtariCNN)),
                FrameReplayBuffer(8, 2, device="cpu"), TrainerConfig(num_envs=2),
                evaluator=object(), device="cpu")
