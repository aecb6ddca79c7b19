"""Port's offline data layer and OfflineTrainer vs the JAX package's.

- both loaders of the committed corpora (``.npz``, and the Minari-format
  HDF5 file when ``h5py`` imports) give the JAX loaders' arrays exactly,
- the ``minari``-package branch against a stub module, as
  ``tests/test_minari.py`` does,
- the replay buffer a dataset fills holds the JAX buffer's contents,
- ``OfflineTrainer`` keeps the JAX trainer's cadence (evaluations, their
  seed indices, ``eval_callback``'s arguments),
- the offline gate configs as ``border_tpu_torch/learning.py`` builds
  them: BC's cosine horizon is the run's own ``max_opts``, and a short BC
  run on the dict corpus raises its normalized score.
"""

import os
import sys
import types

import jax
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from border_tpu.agents import BC as JaxBC
from border_tpu.agents import BCConfig as JaxBCConfig
from border_tpu.data import minari as jminari
from border_tpu.data import datasets as jdatasets
from border_tpu.envs import make as jax_make
from border_tpu.replay import ReplayBuffer as JaxReplayBuffer
from border_tpu.train import Evaluator as JaxEvaluator
from border_tpu.train import OfflineTrainer as JaxOfflineTrainer
from border_tpu.train import TrainerConfig as JaxTrainerConfig
from border_tpu_torch import learning
from border_tpu_torch.agents import BC, BCConfig
from border_tpu_torch.agents.common import lr_at
from border_tpu_torch.data import (
    GoalDictConverter,
    MinariDataset,
    NormalizedEvaluator,
    OfflineDataset,
    collect_dataset,
    converter_for,
    list_local_datasets,
    minari,
    normalized_score,
)
from border_tpu_torch.envs import make
from border_tpu_torch.replay import ReplayBuffer
from border_tpu_torch.train import Evaluator, OfflineTrainer, TrainerConfig

CORPORA = ["pendulum-medium-v0", "fetch-reacher-medium-v0"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The BC runs' 256-wide matmuls on one intra-op thread: beside other
    test processes on the same cores, more threads only wait on each
    other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
KEYS3 = ("observation", "desired_goal", "achieved_goal")


def _assert_same(got, want, what=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), what
        for k in want:
            _assert_same(got[k], want[k], f"{what}.{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def _assert_datasets_equal(got, want):
    for name in ("obs", "act", "next_obs", "reward", "terminated", "truncated"):
        _assert_same(getattr(got, name), getattr(want, name), name)


@pytest.mark.parametrize("dataset_id", CORPORA)
def test_from_npz_matches_jax(dataset_id, tmp_path):
    path = f"{minari.LOCAL_DATASET_DIR}/{dataset_id}.npz"
    got = OfflineDataset.from_npz(path)
    _assert_datasets_equal(got, jdatasets.OfflineDataset.from_npz(path))
    assert len(got) == {"pendulum-medium-v0": 40_000,
                        "fetch-reacher-medium-v0": 25_000}[dataset_id]
    assert isinstance(got.obs, dict) == (dataset_id.startswith("fetch"))
    # save_npz round trip, dict observations too
    got.save_npz(str(tmp_path / "copy.npz"))
    _assert_datasets_equal(OfflineDataset.from_npz(str(tmp_path / "copy.npz")), got)


@pytest.mark.parametrize("dataset_id, keys", [
    ("pendulum-medium-v0", None), ("fetch-reacher-medium-v0", None),
    ("fetch-reacher-medium-v0", KEYS3)])
def test_minari_load_matches_jax(dataset_id, keys):
    conv = (lambda m: None) if keys is None else (lambda m: m.GoalDictConverter(keys))
    got = MinariDataset.load(dataset_id, converter=conv(minari))
    want = jminari.MinariDataset.load(dataset_id, converter=conv(jminari))
    _assert_datasets_equal(got.data, want.data)
    for name in ("dataset_id", "env_name", "ref_min", "ref_max", "behavior_return"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.behavior_normalized_score() == want.behavior_normalized_score()
    assert got.get_num_transitions() == want.get_num_transitions()
    if dataset_id.startswith("fetch"):
        assert got.data.obs.shape[1] == (8 if keys else 6)
        env = got.recover_environment()
        assert env.name == "Reacher-v0-flat"
        assert env.observation_space(None).shape == (6,)


def test_hdf5_loader_matches_jax():
    """The package-free Minari-format loader on the committed full-size
    dict-observation file (the iql_offline gate's corpus) and on a flat
    demo file."""
    pytest.importorskip("h5py")
    for dataset_id, keys in (("fetch-reacher-medium-h5-v0", KEYS3),
                             ("pendulum-demo-v0", None)):
        conv = None if keys is None else GoalDictConverter(keys)
        jconv = None if keys is None else jminari.GoalDictConverter(keys)
        got = MinariDataset.load(dataset_id, converter=conv)
        want = jminari.MinariDataset.load(dataset_id, converter=jconv)
        _assert_datasets_equal(got.data, want.data)
        for name in ("env_name", "ref_min", "ref_max", "behavior_return"):
            assert getattr(got, name) == getattr(want, name), name
    assert len(got.data) > 0
    path = minari._find_minari_hdf5("fetch-reacher-medium-h5-v0")
    jpath = jminari._find_minari_hdf5("fetch-reacher-medium-h5-v0")
    assert os.path.realpath(path) == os.path.realpath(jpath)
    (eg, mg), (ew, mw) = minari.load_minari_hdf5(path), jminari.load_minari_hdf5(path)
    assert mg == mw and len(eg) == len(ew)
    for a, b in zip(eg[:3], ew[:3]):
        _assert_same(a, b)
    # the .npz corpus and the HDF5 one are different collections
    npz = MinariDataset.load("fetch-reacher-medium-v0", converter=GoalDictConverter(KEYS3))
    h5 = MinariDataset.load("fetch-reacher-medium-h5-v0", converter=GoalDictConverter(KEYS3))
    assert len(npz.data) == len(h5.data) and not np.array_equal(npz.data.act, h5.data.act)


def test_hdf5_branch_raises_without_h5py(monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError):
        MinariDataset.load("fetch-reacher-medium-h5-v0")


class _StubEpisode:
    def __init__(self, T, obs_dim, dict_obs=False, seed=0):
        rng = np.random.RandomState(seed)
        if dict_obs:
            self.observations = {
                "observation": rng.randn(T + 1, obs_dim).astype(np.float32),
                "desired_goal": rng.randn(T + 1, 2).astype(np.float32),
                "achieved_goal": rng.randn(T + 1, 2).astype(np.float32),
            }
        else:
            self.observations = rng.randn(T + 1, obs_dim).astype(np.float32)
        self.actions = rng.randn(T, 1).astype(np.float32)
        self.rewards = rng.randn(T).astype(np.float32)
        self.terminations = np.zeros(T, bool)
        self.terminations[-1] = seed % 2 == 0
        self.truncations = ~self.terminations


class _StubDataset:
    def __init__(self, episodes, env_id="Pendulum-v1"):
        self._episodes = episodes
        self.spec = types.SimpleNamespace(env_spec=types.SimpleNamespace(id=env_id))
        self.ref_min_score = -100.0
        self.ref_max_score = 0.0

    def iterate_episodes(self):
        return iter(self._episodes)


@pytest.fixture
def stub_minari(monkeypatch):
    mod = types.ModuleType("minari")
    mod._store = {}
    mod.load_dataset = lambda dataset_id: mod._store[dataset_id]
    monkeypatch.setitem(sys.modules, "minari", mod)
    return mod


def test_minari_package_branch_against_stub(stub_minari):
    """≙ tests/test_minari.py: flat and dict episodes through the package
    branch, on both sides."""
    stub_minari._store["test/flat-v0"] = _StubDataset(
        [_StubEpisode(10, 3, seed=s) for s in range(4)])
    got = OfflineDataset.from_minari("test/flat-v0")
    _assert_datasets_equal(got, jdatasets.OfflineDataset.from_minari("test/flat-v0"))
    assert len(got) == 40 and (got.terminated | got.truncated).sum() == 4
    np.testing.assert_array_equal(got.next_obs[:9], got.obs[1:10])

    stub_minari._store["pointmaze/test-v0"] = _StubDataset(
        [_StubEpisode(8, 4, dict_obs=True, seed=s) for s in range(3)])
    md = MinariDataset.load("pointmaze/test-v0")
    jmd = jminari.MinariDataset.load("pointmaze/test-v0")
    _assert_datasets_equal(md.data, jmd.data)
    assert md.data.obs.shape == (24, 6)
    assert (md.env_name, md.ref_min, md.ref_max) == ("Pendulum-v1", -100.0, 0.0)
    assert md.recover_environment().name == "Pendulum-v1"
    state = md.create_replay_buffer(ReplayBuffer(64, device="cpu"))
    assert state.size == 24 and state.data.obs.shape == (64, 6)


@pytest.mark.parametrize("branch", ["hdf5", "local"])
def test_fallback_failure_chains_the_package_error(stub_minari, monkeypatch,
                                                   branch):
    """Whichever on-disk fallback fails after the package did, the final
    error's ``__cause__`` is the package's error (the JAX loader chains
    only a ``KeyError`` of the local corpora)."""
    pkg_err = RuntimeError("minari package: dataset not served")

    def load_dataset(dataset_id):
        raise pkg_err

    stub_minari.load_dataset = load_dataset
    if branch == "hdf5":
        # a committed Minari-format HDF5 and no .npz; h5py blocked
        monkeypatch.setitem(sys.modules, "h5py", None)
        dataset_id, raised = "pendulum-demo-v0", ImportError
    else:
        def broken_local(dataset_id, converter=None):
            raise OSError("local corpus unreadable")

        monkeypatch.setattr(MinariDataset, "_from_local", broken_local)
        dataset_id, raised = "no-such-corpus-v0", OSError
    with pytest.warns(UserWarning, match="minari package failed"):
        with pytest.raises(raised) as info:
            MinariDataset.load(dataset_id)
    assert info.value.__cause__ is pkg_err


def test_minari_without_package_and_registry():
    with pytest.raises(KeyError, match="pendulum-medium-v0"):
        MinariDataset.load("no-such-dataset-v0")
    assert list_local_datasets() == jminari.list_local_datasets() == CORPORA[::-1]
    assert isinstance(converter_for("pointmaze/umaze-v2"), GoalDictConverter)
    assert converter_for("kitchen/x").keys == ("observation",)
    assert not isinstance(converter_for("pen/human-v2"), GoalDictConverter)
    assert set(minari.CONVERTERS) == set(jminari.CONVERTERS)
    with pytest.raises(ImportError, match="minari"):
        OfflineDataset.from_minari("pen/human-v2")


@pytest.mark.parametrize("dataset_id, limit", [("pendulum-medium-v0", None),
                                              ("fetch-reacher-medium-v0", 1000)])
def test_replay_buffer_from_dataset_matches_jax(dataset_id, limit):
    md = MinariDataset.load(dataset_id)
    jmd = jminari.MinariDataset.load(dataset_id)
    cap = limit or len(md.data)
    st = md.create_replay_buffer(ReplayBuffer(cap, device="cpu"), limit=limit)
    jst = jmd.create_replay_buffer(JaxReplayBuffer(cap), limit=limit)
    assert (st.size, st.cursor) == (int(jst.size), int(jst.cursor))
    for name in ("obs", "act", "next_obs", "reward", "terminated", "truncated"):
        _assert_same(getattr(st.data, name).numpy(), getattr(jst.data, name), name)


def test_raw_dict_corpus_fills_a_dict_buffer():
    ds = OfflineDataset.from_npz(f"{minari.LOCAL_DATASET_DIR}/fetch-reacher-medium-v0.npz")
    st = ds.to_replay_buffer(ReplayBuffer(512, device="cpu"))
    assert set(st.data.obs) == {"achieved_goal", "desired_goal", "observation"}
    assert st.size == 512 and st.data.next_obs["observation"].shape == (512, 4)
    np.testing.assert_array_equal(st.data.obs["desired_goal"].numpy(),
                                  ds.obs["desired_goal"][:512])


def test_collect_dataset_shapes_match_jax():
    env, jenv = make("Reacher-v0"), jax_make("Reacher-v0")
    agent = BC(BCConfig(hidden=(8,)))
    from border_tpu_torch.core import spaces

    ob = spaces.Box(-np.inf, np.inf, (8,), torch.float32)
    st = agent.init(0, ob, env.action_space(None), device="cpu")
    flat = make("ReacherFlat-v0")
    got = collect_dataset(flat, agent, st, n_steps=64, num_envs=8, device="cpu")
    assert got.obs.shape == (64, 8) and got.act.shape == (64, 2)
    assert got.reward.dtype == np.float32 and got.truncated.dtype == bool
    # dict observations stay dicts, flattened per key like the JAX collector's
    jagent = JaxBC(JaxBCConfig(hidden=(8,)))
    from border_tpu.core import spaces as jspaces
    jst = jagent.init(jax.random.PRNGKey(0), jspaces.Box(-np.inf, np.inf, (8,)),
                      jenv.action_space(None))

    class Flat:  # acts on the flattened dict observation
        def __init__(self, a, flatten):
            self.a, self.flatten = a, flatten

        def select_action(self, s, obs, k):
            return self.a.select_action(s, self.flatten(obs), k)

    want = jdatasets.collect_dataset(
        jenv, Flat(jagent, lambda o: jax.numpy.concatenate(
            [o[k] for k in sorted(o)], -1)), jst, n_steps=64, num_envs=8)
    got = collect_dataset(
        env, Flat(agent, lambda o: torch.cat([o[k] for k in sorted(o)], -1)), st,
        n_steps=64, num_envs=8, device="cpu")
    for name in ("obs", "act", "next_obs", "reward", "terminated", "truncated"):
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(w, dict):
            assert {k: v.shape for k, v in g.items()} == {k: v.shape for k, v in w.items()}
        else:
            assert g.shape == w.shape and g.dtype == w.dtype, name


def test_normalized_evaluator_matches_jax_record():
    assert normalized_score(-20.0, -35.0, -10.0) == jdatasets.normalized_score(
        -20.0, -35.0, -10.0) == 60.0
    ev = NormalizedEvaluator(make("ReacherGoal-v0"), n_episodes=4, max_steps=5,
                             ref_min=-35.0, ref_max=-10.0, device="cpu")
    agent = BC(BCConfig(hidden=(8,)))
    st = agent.init(0, ev.vec.observation_space, ev.vec.action_space, device="cpu")
    score, rec = ev.evaluate(agent, st, eval_index=3)
    assert {k for k, _ in rec} == chip_smoke.EVAL_KEYS | {"Normalized score"}
    assert rec["Normalized score"] == normalized_score(score, -35.0, -10.0)


class _CountingEvaluator:
    """An evaluator that returns its call number as the score and keeps the
    ``eval_index`` it was given."""

    def __init__(self, record_cls):
        self.indices, self.record_cls = [], record_cls

    def evaluate(self, agent, state, eval_index=0):
        self.indices.append(eval_index)
        score = [3.0, 1.0, 5.0, 2.0][len(self.indices) - 1]
        return score, self.record_cls({"Episode return": score})


def test_offline_trainer_cadence_matches_jax():
    """The same config through both trainers: evaluations at the same
    update counts, with the same seed indices and callback arguments."""
    from border_tpu.core import spaces as jspaces
    from border_tpu.record.record import Record as JaxRecord
    from border_tpu_torch.core import spaces
    from border_tpu_torch.record.record import Record

    md, jmd = MinariDataset.load("pendulum-medium-v0"), jminari.MinariDataset.load(
        "pendulum-medium-v0")
    # chunks of 10 updates, an evaluation due every 15: it runs at the
    # first chunk end past each due point
    cfg = dict(max_opts=60, batch_size=16, eval_interval=15, seed=0)
    calls = {"port": [], "jax": []}
    ev, jev = _CountingEvaluator(Record), _CountingEvaluator(JaxRecord)
    buf = ReplayBuffer(2048, device="cpu")
    agent = BC(BCConfig(hidden=(8,)))
    st = agent.init(0, spaces.Box(-np.inf, np.inf, (3,), torch.float32),
                    spaces.Box(-2.0, 2.0, (1,), torch.float32), device="cpu")
    r = OfflineTrainer(agent, buf, TrainerConfig(**cfg), evaluator=ev,
                       updates_per_chunk=10,
                       eval_callback=lambda *a: calls["port"].append(a)).train(
        st, md.create_replay_buffer(buf, limit=2048))
    jbuf = JaxReplayBuffer(2048)
    jagent = JaxBC(JaxBCConfig(hidden=(8,)))
    jst = jagent.init(jax.random.PRNGKey(0), jspaces.Box(-np.inf, np.inf, (3,)),
                      jspaces.Box(-2.0, 2.0, (1,)))
    jr = JaxOfflineTrainer(jagent, jbuf, JaxTrainerConfig(**cfg), evaluator=jev,
                           updates_per_chunk=10,
                           eval_callback=lambda *a: calls["jax"].append(a)).train(
        jst, jmd.create_replay_buffer(jbuf, limit=2048))
    assert r.opt_steps == jr.opt_steps == 60 and r.env_steps == 0
    assert r.eval_history == jr.eval_history == [
        (20, 3.0), (30, 1.0), (50, 5.0), (60, 2.0)]
    assert ev.indices == jev.indices == [0, 1, 2, 3]
    assert calls["port"] == calls["jax"] == [
        (20, 0, 3.0, 3.0), (30, 0, 1.0, 3.0), (50, 0, 5.0, 5.0), (60, 0, 2.0, 5.0)]
    assert r.best_score == jr.best_score == 5.0


def test_offline_trainer_feeds_td_errors_to_a_prioritized_buffer():
    from border_tpu_torch.agents import IQL, IQLConfig
    from border_tpu_torch.replay import PerConfig

    md = MinariDataset.load("pendulum-medium-v0")
    buf = ReplayBuffer(1024, per=PerConfig(), device="cpu")
    st = md.create_replay_buffer(buf, limit=1024)
    before = st.tree.sum_tree.clone()
    agent = IQL(IQLConfig(actor_hidden=(8,), critic_hidden=(8,), value_hidden=(8,)))
    from border_tpu_torch.core import spaces

    ast = agent.init(0, spaces.Box(-np.inf, np.inf, (3,), torch.float32),
                     spaces.Box(-2.0, 2.0, (1,), torch.float32), device="cpu")
    rec = chip_smoke._chunk_recorder()
    r = OfflineTrainer(agent, buf, TrainerConfig(max_opts=6, batch_size=32),
                       recorder=rec, updates_per_chunk=3).train(ast, st)
    assert r.opt_steps == 6 and len(rec.chunks) == 2
    assert not torch.equal(before, r.buffer_state.tree.sum_tree)
    assert {k for k, _ in rec.chunks[0]} == {
        "loss_value", "loss_critic", "loss_actor", "adv_mean", "v_mean",
        "opt_steps_per_sec"}


def test_bc_horizon_is_the_runs_max_opts():
    """The reference hard-codes BC's cosine horizon at 12,000 updates: a run
    cut to 3,000 would end at 0.85 of the initial rate.  The port builds it
    from max_opts: the rate reaches 0 at the run's last update."""
    _, agent, cfg, _ = learning.offline_config("bc_offline", "cpu", max_opts=3_000)
    assert cfg.max_opts == 3_000
    assert lr_at(agent.config.lr, 0) == float(np.float32(1e-3))
    assert lr_at(agent.config.lr, 3_000) == 0.0
    assert 0 < lr_at(agent.config.lr, 2_999) < 1e-9
    reference = float(optax.cosine_decay_schedule(1e-3, 12_000)(3_000))
    assert 0.85e-3 < reference < 0.86e-3
    _, agent, cfg, _ = learning.offline_config("bc_offline", "cpu")
    assert cfg.max_opts == 12_000 and lr_at(agent.config.lr, 12_000) == 0.0


@pytest.mark.parametrize("name", ["bc_offline", "awac_offline", "iql_offline"])
def test_offline_gate_configs_construct_and_train(name):
    md, agent, cfg, ev = learning.offline_config(name, "cpu", max_opts=4)
    assert md.data.obs.shape == (25_000, 8) and cfg.batch_size == 256
    assert (ev.n_episodes, ev.max_steps) == (200, 50)
    assert ev.vec.observation_space.shape == (8,)
    buf = ReplayBuffer(md.get_num_transitions(), device="cpu")
    st = agent.init(0, ev.vec.observation_space, ev.vec.action_space, device="cpu")
    rec = chip_smoke._chunk_recorder()
    r = OfflineTrainer(agent, buf, cfg, recorder=rec, updates_per_chunk=2).train(
        st, md.create_replay_buffer(buf))
    assert r.opt_steps == 4 and all(
        np.isfinite(v) for c in rec.chunks for _, v in c)


def test_bc_learns_on_the_dict_corpus():
    """The bc_offline config cut to 1,000 updates (its cosine horizon with
    it) and 50-episode evaluations every 250: the normalized score climbs
    from its first evaluation."""
    md, agent, cfg, _ = learning.offline_config("bc_offline", "cpu", max_opts=1_000)
    ev = NormalizedEvaluator(chip_smoke_env(), n_episodes=50, max_steps=50,
                             ref_min=md.ref_min, ref_max=md.ref_max, device="cpu")
    buf = ReplayBuffer(md.get_num_transitions(), device="cpu")
    st = agent.init(0, ev.vec.observation_space, ev.vec.action_space, device="cpu")
    r = OfflineTrainer(agent, buf, cfg.replace(eval_interval=250), evaluator=ev,
                       updates_per_chunk=250).train(st, md.create_replay_buffer(buf))
    scores = [normalized_score(s, md.ref_min, md.ref_max) for _, s in r.eval_history]
    assert len(scores) == 4
    assert max(scores[1:]) > scores[0] + 5 and max(scores) > 50, scores


def chip_smoke_env():
    from border_tpu_torch.envs.reacher import FlattenDictWrapper

    return FlattenDictWrapper(make("Reacher-v0"), keys=learning.OFFLINE_KEYS)


def test_evaluator_accepts_the_reacher_goal_env():
    """The recovered env of the dict corpus evaluates through the port's
    Evaluator, its resets seeded by the evaluation index."""
    ev = Evaluator(make("ReacherGoal-v0"), n_episodes=3, max_steps=50, device="cpu")
    agent = BC(BCConfig(hidden=(8,)))
    st = agent.init(0, ev.vec.observation_space, ev.vec.action_space, device="cpu")
    a, _ = ev.evaluate(agent, st, 1)
    b, _ = ev.evaluate(agent, st, 1)
    c, rec = ev.evaluate(agent, st, 2)
    assert a == b != c and rec["Episode length"] == 50.0
    assert JaxEvaluator is not None  # the JAX evaluator is the reference
