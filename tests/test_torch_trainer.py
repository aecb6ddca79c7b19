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
import os

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
from border_tpu_torch.record import BufferedRecorder, Record, TensorboardRecorder
from border_tpu_torch.replay import FrameReplayBuffer, PerConfig
from border_tpu_torch.train import Evaluator, Trainer, TrainerConfig

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
    tv = convert.vec_env_state(jv, seed_or_gen=0, device="cpu")
    tb = convert.frame_replay_state(jb, device="cpu")
    return ta, tv, tb


def _assert_buffers_equal(tb, jb):
    carried = convert.frame_replay_state(jb, device="cpu")
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

    def trainer(buffer_kw=None, **kw):
        return Trainer(make("Pong-v0"), DQN(DQNConfig(model=AtariCNN)),
                       FrameReplayBuffer(8, 2, device="cpu", **(buffer_kw or {})),
                       TrainerConfig(num_envs=2).replace(**kw), device="cpu")

    trainer()  # the defaults are accepted
    # every knob of the JAX trainer is ported: none raises by itself
    # (64 env steps × 2 envs / opt_interval 1 = 128 updates a chunk)
    for kw in (dict(prefetch_sample=True), dict(updates_per_sample_batch=2),
               dict(save_interval=10)):
        trainer(**kw)
    assert trainer(updates_per_sample_batch=64).updates_per_chunk == 128
    with pytest.raises(ConfigError, match="must divide the chunk's update"):
        trainer(updates_per_sample_batch=3)
    # slice mode: every sub-batch must hold whole groups (the JAX check
    # lacks this)
    slice_kw = dict(sample_mode="slice", slice_group=2)
    trainer(slice_kw, updates_per_sample_batch=2, batch_size=64)
    with pytest.raises(ConfigError, match="must divide batch_size"):
        trainer(slice_kw, updates_per_sample_batch=2, batch_size=63)
    # n-step buffers: clip_reward and a differing gamma are refused
    with pytest.raises(ConfigError, match="clip_reward"):
        Trainer(make("Pong-v0"),
                DQN(DQNConfig(model=AtariCNN, clip_reward=1.0)),
                FrameReplayBuffer(8, 2, n_step=3, device="cpu"),
                TrainerConfig(num_envs=2), device="cpu")
    with pytest.raises(ConfigError, match="gamma"):
        trainer(dict(n_step=3, gamma=0.9))
    tr = Trainer(make("Pong-v0"), DQN(DQNConfig(model=AtariCNN)),
                 FrameReplayBuffer(8, 2, device="cpu"), TrainerConfig(num_envs=2),
                 evaluator=object(), checkpoint_manager=object(),
                 checkpoint_interval=5, eval_callback=print, device="cpu")
    assert tr.checkpoint_interval == 5 and tr.eval_callback is print


def _jax_uniform_draws(key, total, b):
    """The (e, s) the JAX buffer's uniform branch draws for ``key``."""
    size = min(total, CAP)
    k_e, k_s = jax.random.split(key)
    e = jax.random.randint(k_e, (b,), 0, N)
    s = jax.random.randint(k_s, (b,), total - size + 4, total - 1)
    return (torch.from_numpy(np.asarray(e, np.int64)),
            torch.from_numpy(np.asarray(s, np.int64)))


@pytest.mark.parametrize("variant", ["updates_per_sample_batch", "prefetch_sample"])
def test_update_scan_variants_match_jax_trainer(variant, monkeypatch):
    """Two updates a chunk through ``_update_scan``'s two other orders, the
    JAX trainer's replay draws injected in its order: mean loss and q agree
    to rtol 1e-4 (float32 convolutions summed in another order)."""
    kw = {"updates_per_sample_batch": 2} if variant.startswith("updates") else {
        "prefetch_sample": True}
    cfg = dict(num_envs=N, steps_per_chunk=K, batch_size=B,
               opt_interval=K * N // 2, warmup_period=0, **kw)
    jtr = JaxTrainer(
        jax_make("Pong-v0"),
        JaxDQN(JaxDQNConfig(model=lambda n: JaxAtariCNN(n, dtype=jnp.float32),
                            **AGENT_KW)),
        JaxFrameReplayBuffer(capacity=CAP, num_envs=N), JaxTrainerConfig(**cfg))
    ttr = Trainer(
        make("Pong-v0"),
        DQN(DQNConfig(model=lambda n: AtariCNN(n, dtype=torch.float32),
                      **AGENT_KW)),
        FrameReplayBuffer(capacity=CAP, num_envs=N, device="cpu"),
        TrainerConfig(**cfg), device="cpu")
    assert jtr.updates_per_chunk == ttr.updates_per_chunk == 2
    ja, jv, jb = jtr.init_states(jax.random.PRNGKey(0), jax.random.PRNGKey(1))
    ja, jv, jb, _, _ = jax.jit(
        lambda a, v, b, k: jtr._env_scan(a, v, b, k, explore=False)
    )(ja, jv, jb, jax.random.PRNGKey(2))
    ta, _, tb = _carry(jtr, ttr, ja, jv, jb)

    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, 3)
    if variant.startswith("updates"):
        # one body iteration: ks = split(keys[1], ups + 1), sample on ks[0]
        sample_keys = [(jax.random.split(keys[1], 3)[0], 2 * B)]
    else:
        # batch0 on keys[0], then one sample per iteration on split(k)[0]
        sample_keys = [(keys[0], B)] + [
            (jax.random.split(k)[0], B) for k in keys[1:]]
    draws = iter([_jax_uniform_draws(k, tb.total, b) for k, b in sample_keys])
    sizes = []

    def draw(state, gen, b):
        sizes.append(b)
        return next(draws)

    monkeypatch.setattr(ttr.buffer, "draw", draw)
    ja, jb, jm = jax.jit(jtr._update_scan)(ja, jb, key)
    ta, tb, tm = ttr._update_scan(ta, tb, torch.Generator().manual_seed(3))
    assert sizes == [b for _, b in sample_keys]
    assert ta.n_opts == int(ja.n_opts) == 2
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(tm["q_mean"].item(), float(jm["q_mean"]),
                               rtol=1e-4, atol=1e-6)


def _small_trainer(recorder=None, evaluator=None, buffer_kw=None, **cfg):
    base = dict(num_envs=8, steps_per_chunk=8, batch_size=16, opt_interval=16,
                warmup_period=0, max_opts=4)
    agent = DQN(DQNConfig(model=lambda n: AtariCNN(n, dtype=torch.float32),
                          lr=1e-4, double_dqn=True))
    return Trainer(make("Pong-v0"), agent,
                   FrameReplayBuffer(capacity=32, num_envs=8, device="cpu",
                                     **(buffer_kw or {})),
                   TrainerConfig(**{**base, **cfg}), recorder=recorder,
                   evaluator=evaluator, device="cpu")


def _params(result):
    return [p.detach().clone() for p in result.agent_state.params.parameters()]


def test_prefetch_and_sub_batches_leave_the_first_update_chunk_unchanged():
    """``prefetch_sample`` only reorders the launches: the first update
    chunk draws the same samples in the same order (one more at its end),
    so the parameters are bitwise those of the sequential loop.  With
    ``updates_per_sample_batch`` = 2 one draw of 32 replaces two of 16:
    other samples, same number of updates."""
    plain = _small_trainer().train()
    pre = _small_trainer(prefetch_sample=True).train()
    assert plain.opt_steps == pre.opt_steps == 4
    assert all(torch.equal(a, b) for a, b in zip(_params(plain), _params(pre)))
    ups = _small_trainer(updates_per_sample_batch=2).train()
    assert ups.opt_steps == 4
    assert not all(torch.equal(a, b) for a, b in zip(_params(plain), _params(ups)))
    assert all(torch.isfinite(p).all() for p in _params(ups))


@pytest.mark.parametrize(
    "buffer_kw",
    [dict(sample_mode="slice", slice_group=4), dict(sample_mode="separate"),
     dict(n_step=3), dict(sort_samples=True),
     dict(per=PerConfig(n_opts_final=8))],
    ids=["slice", "separate", "nstep3", "sorted", "per"],
)
def test_train_cpu_smoke_every_buffer_mode(buffer_kw):
    rec = BufferedRecorder()
    r = _small_trainer(recorder=rec, buffer_kw=buffer_kw, max_opts=8,
                       flush_record_interval=1).train()
    # n-step 3 needs two chunks of pushes before 16 samples are resident
    assert r.opt_steps == 8
    assert r.buffer_state.total == (32 if "n_step" in buffer_kw else 24)
    losses = rec.scalars("loss")
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    if "per" in buffer_kw:
        tree = r.buffer_state.tree
        assert 0 < tree.sum_tree[1].item() < float("inf")
        live = tree.sum_tree[r.buffer_state.frames.shape[0] * 32:]
        live = live[live > 0]
        assert len(live.unique()) > 1  # priorities were fed back


def test_best_model_and_periodic_saves_land_in_model_dir(tmp_path):
    rec = BufferedRecorder(model_dir=str(tmp_path / "models"))
    ev = Evaluator(make("Pong-v0", train=False), n_episodes=2, max_steps=3,
                   device="cpu")
    r = _small_trainer(recorder=rec, evaluator=ev, max_opts=12, eval_interval=4,
                       save_interval=8).train()
    # a save at 8; the next cadence point is 16, past the run's end
    assert sorted(os.listdir(tmp_path / "models")) == ["8", "best"]
    assert [s for s, _ in r.eval_history] == [4, 8, 12]
    assert r.best_score == 0.0  # no point is scored in 3 steps
    assert rec.scalars("Episode return") == [0.0, 0.0, 0.0]
    # "best" is the FIRST evaluation's model: later equal scores do not
    # replace it
    tr = _small_trainer()
    best = rec.load_model("best", tr.agent, tr.init_states(0, 1)[0])
    assert best.n_opts == 4
    # without a model_dir nothing is saved and nothing raises
    _small_trainer(recorder=BufferedRecorder(), evaluator=ev, max_opts=8,
                   eval_interval=4, save_interval=4).train()


def test_tensorboard_recorder_writes_a_readable_event_file(tmp_path):
    import glob

    from tensorboard.backend.event_processing import event_file_loader

    rec = TensorboardRecorder(str(tmp_path / "tb"))
    assert rec.model_dir == str(tmp_path / "tb" / "model")
    r = _small_trainer(recorder=rec, max_opts=8, flush_record_interval=4).train()
    rec.write_at(Record({"q": torch.arange(6.0).reshape(2, 3),
                         "w": torch.arange(5.0), "note": "text"}), 9)
    rec.flush(9)
    rec.close()
    assert r.opt_steps == 8
    path = glob.glob(str(tmp_path / "tb" / "events.*"))[0]
    events = list(event_file_loader.LegacyEventFileLoader(path).Load())
    assert events[0].file_version == "brain.Event:2"
    scalars = {(e.step, v.tag) for e in events for v in e.summary.value
               if v.HasField("simple_value")}
    assert {(4, "loss"), (8, "loss"), (8, "opt_steps")} <= scalars
    images = [v for e in events for v in e.summary.value if v.HasField("image")]
    assert images[0].tag == "q" and images[0].image.width == 3
    histos = [v for e in events for v in e.summary.value if v.HasField("histo")]
    assert histos[0].tag == "w" and histos[0].histo.num == 5.0


# -- the flat-buffer path and the learning-gate configs ----------------------

def test_init_states_sizes_a_flat_buffer_from_the_spaces():
    """``init_states`` hands the flat buffer an example transition built from
    the env's spaces, as the JAX trainer does; the frame buffer ignores it."""
    from border_tpu.replay import ReplayBuffer as JaxReplayBuffer
    from border_tpu_torch.replay import ReplayBuffer

    cfg = dict(num_envs=N, steps_per_chunk=K, batch_size=B, opt_interval=N,
               warmup_period=0)
    for env_id in ("CartPole-v1", "Acrobot-v1", "MountainCar-v0"):
        jtr = JaxTrainer(jax_make(env_id), JaxDQN(JaxDQNConfig()),
                         JaxReplayBuffer(64), JaxTrainerConfig(**cfg))
        ttr = Trainer(make(env_id), DQN(DQNConfig()),
                      ReplayBuffer(64, device="cpu"), TrainerConfig(**cfg),
                      device="cpu")
        _, _, jb = jtr.init_states(jax.random.PRNGKey(0), jax.random.PRNGKey(1))
        ta, tv, tb = ttr.init_states(0, 1)
        for name in ("obs", "act", "next_obs", "reward", "terminated", "truncated"):
            got, want = getattr(tb.data, name), getattr(jb.data, name)
            assert tuple(got.shape) == tuple(want.shape), (env_id, name)
            assert str(got.dtype).split(".")[1] == str(want.dtype), (env_id, name)
        assert tb.size == tb.cursor == 0 and tb.tree is None
        assert tuple(tv.obs.shape) == (N, *jtr.vec.observation_space.shape)
        assert ta.params.layers[0].in_features == tv.obs.shape[1]
    # the frame buffer takes the example and keeps its own shapes
    _, ttr = _trainers()
    assert tuple(ttr.init_states(0, 1)[2].frames.shape) == (N, CAP, 84, 84)


def _gate_config(name, width):
    """The ``benchmarks/learning.py`` config ``name`` written with the port's
    classes argument for argument, at ``width`` envs and a short run."""
    import functools

    from border_tpu_torch.agents import IQN, IQNConfig
    from border_tpu_torch.replay import ReplayBuffer

    cnn_dqn = dict(model=lambda n: AtariCNN(out_dim=n), lr=1e-4, double_dqn=True,
                   soft_update_interval=2_000, tau=1.0, eps_final_step=1_000_000)
    short = dict(max_opts=2, warmup_period=0, opt_interval=width * 4,
                 batch_size=8, num_envs=width, steps_per_chunk=8,
                 eval_interval=2, seed=0)
    pixel_eval = dict(n_episodes=2, max_steps=6, device="cpu")
    if name == "cartpole":
        env = make("CartPole-v1")
        agent = DQN(DQNConfig(hidden=(64, 64), lr=5e-4, gamma=0.99, tau=1.0,
                              soft_update_interval=500, double_dqn=True,
                              eps_final_step=10_000))
        buffer = ReplayBuffer(capacity=65_536, n_step=3, stride=width,
                              device="cpu")
        evaluator = Evaluator(env, n_episodes=20, max_steps=500, device="cpu")
        short["warmup_period"] = 8
    elif name == "seaquest":
        env = make("Seaquest-v0")
        agent = IQN(IQNConfig(
            psi_fn=functools.partial(AtariCNN, out_dim=0, skip_linear=True),
            feature_dim=512, n_cos=64, hidden=(512,),
            sample_percents_pred="uniform8", sample_percents_tgt="uniform8",
            sample_percents_act="const32", lr=1e-4,
            soft_update_interval=2_000, tau=1.0, eps_final_step=2_000_000))
        buffer = FrameReplayBuffer(capacity=16, num_envs=width, device="cpu")
        evaluator = Evaluator(make("Seaquest-v0", train=False), **pixel_eval)
    else:
        env_id = {"breakout": "Breakout-v0", "freeway": "Freeway-v0",
                  "spaceinvaders": "SpaceInvaders-v0"}[name]
        env = make(env_id)
        kw = dict(cnn_dqn, gamma=0.99) if name == "freeway" else cnn_dqn
        agent = DQN(DQNConfig(**kw))
        buf_kw = {"breakout": {}, "freeway": dict(n_step=3, gamma=0.99),
                  "spaceinvaders": dict(n_step=3)}[name]
        buffer = FrameReplayBuffer(capacity=16, num_envs=width, device="cpu",
                                   **buf_kw)
        evaluator = Evaluator(make(env_id, train=False), **pixel_eval)
    return Trainer(env, agent, buffer, TrainerConfig(**short),
                   evaluator=evaluator, device="cpu")


@pytest.mark.parametrize(
    "name", ["cartpole", "seaquest", "breakout", "freeway", "spaceinvaders"])
def test_learning_gate_configs_construct_and_train(name, monkeypatch):
    """Each new gate config builds a Trainer and runs two updates and an
    evaluation on the CPU at reduced width; the pixel ones sample through
    ``gather_frames`` (once a sample, twice with n-step 3)."""
    calls = []
    monkeypatch.setattr(
        "border_tpu_torch.replay.frame_buffer.gather_frames",
        lambda frames, idx: calls.append(tuple(idx.shape))
        or frame_gather.gather_frames_ref(frames, idx))
    tr = _gate_config(name, width=4)
    r = tr.train()
    assert r.opt_steps == 2 and len(r.eval_history) == 1
    assert math.isfinite(r.eval_history[0][1])
    assert all(torch.isfinite(p).all() for p in r.agent_state.params.parameters())
    want = {"cartpole": [], "seaquest": [(8, 5)] * 2, "breakout": [(8, 5)] * 2,
            "freeway": [(8, 4)] * 4, "spaceinvaders": [(8, 4)] * 4}[name]
    assert calls == want


def test_cartpole_learns_on_the_cpu_at_reduced_size():
    """The ``cartpole`` gate config cut to 2,000 updates: the evaluation
    score climbs well past a random policy's (about 20)."""
    from border_tpu_torch.replay import ReplayBuffer

    env = make("CartPole-v1")
    agent = DQN(DQNConfig(hidden=(64, 64), lr=5e-4, gamma=0.99, tau=1.0,
                          soft_update_interval=500, double_dqn=True,
                          eps_final_step=10_000))
    cfg = TrainerConfig(max_opts=2_000, warmup_period=1_000, opt_interval=16,
                        batch_size=256, num_envs=32, steps_per_chunk=32,
                        eval_interval=500, seed=0)
    tr = Trainer(env, agent, ReplayBuffer(65_536, n_step=3, stride=32, device="cpu"),
                 cfg, evaluator=Evaluator(env, n_episodes=5, max_steps=500,
                                          device="cpu"), device="cpu")
    r = tr.train()
    assert r.opt_steps >= 2_000 and len(r.eval_history) == 4
    assert r.best_score >= 60.0, r.eval_history
