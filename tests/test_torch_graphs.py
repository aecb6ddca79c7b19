"""The CUDA-graph machinery's CPU side: the ``cuda_graphs`` switch, the
helpers a graphed body writes its results with, and the card's counter
formulation (``counts``, :mod:`border_tpu_torch.utils.counters`) held
against the CPU path's host ints.

A state on the card carries its counters as a device tensor and the card's
code paths read that tensor; here the same paths run on CPU states given a
``counts`` tensor by hand, against the same states without one.  Pushes,
rings, trees, injected draws and updates must agree bitwise; the importance
weights to 1e-6 relative (a power by a tensor exponent and by a Python one
may round apart by an ulp); a schedule's rate within 2 float32 ulps of the
initial rate (the DQN rate decay, float32 on the card, double on the host)
or of the value (the cosine, whose ``cos`` comes from torch on one side and
numpy on the other).
"""

import collections
import contextlib
import dataclasses
import gc
import types

import numpy as np
import pytest
import torch

from border_tpu_torch.agents import DQN, DQNConfig
from border_tpu_torch.agents.common import (
    cosine_decay_schedule,
    periodic_polyak,
)
from border_tpu_torch.core import spaces
from border_tpu_torch.core.env import Timestep
from border_tpu_torch.envs import make
from border_tpu_torch.errors import ConfigError
from border_tpu_torch.ops import COUNTED, gather_frames
from border_tpu_torch.replay import (
    FrameReplayBuffer,
    PerConfig,
    ReplayBuffer,
    Transition,
    TransitionBatch,
)
from border_tpu_torch.train import (
    AsyncTrainer,
    Evaluator,
    HostEnvTrainer,
    HostEvaluator,
    OfflineTrainer,
    Trainer,
    TrainerConfig,
)
from border_tpu_torch.train import graphs
from border_tpu_torch.train.graphs import (
    GraphCaptureError,
    _leaves,
    add_metrics_,
    bound_loop,
    copy_into,
    no_collection,
)
from border_tpu_torch.train.trainer import example_transition, resolve_cuda_graphs
from border_tpu_torch.utils.counters import (
    count,
    linear_f32,
    randint_below,
    sync_counters,
)


def _with_counts(state):
    """``state`` given the device twin of its counters, on the CPU."""
    state.counts = torch.tensor([getattr(state, n) for n in type(state).COUNTERS])
    return state


# -- the switch --------------------------------------------------------------

def _with_switch(cls, cuda_graphs):
    """A CPU instance of a trainer or an evaluator given ``cuda_graphs``."""
    if cls is Evaluator:
        return Evaluator(make("CartPole-v1"), 2, 10, device="cpu",
                         cuda_graphs=cuda_graphs)
    if cls is HostEvaluator:
        return HostEvaluator("CartPole-v1", 2, 10, cuda_graphs=cuda_graphs)
    env = "CartPole-v1" if cls is HostEnvTrainer else make("CartPole-v1")
    return cls(env, DQN(), ReplayBuffer(64, device="cpu"),
               TrainerConfig(num_envs=4), device="cpu", cuda_graphs=cuda_graphs)


@pytest.mark.parametrize("cls", [Trainer, AsyncTrainer, HostEnvTrainer,
                                 Evaluator, HostEvaluator])
def test_cuda_graphs_true_on_cpu_raises(cls):
    with pytest.raises(ConfigError, match="CUDA"):
        _with_switch(cls, True)
    with pytest.raises(ConfigError, match="CUDA"):
        OfflineTrainer(DQN(), ReplayBuffer(64, device="cpu"), cuda_graphs=True)


@pytest.mark.parametrize("cuda_graphs", [None, False])
def test_cpu_trainers_run_eagerly(cuda_graphs):
    tr = Trainer(make("CartPole-v1"), DQN(), ReplayBuffer(64, device="cpu"),
                 TrainerConfig(num_envs=4), device="cpu",
                 cuda_graphs=cuda_graphs)
    off = OfflineTrainer(DQN(), ReplayBuffer(64, device="cpu"),
                         cuda_graphs=cuda_graphs)
    assert tr.cuda_graphs is False and off.cuda_graphs is False


@pytest.mark.parametrize("asked, device, graphable, want", [
    (None, "cpu", True, False), (False, "cpu", True, False),
    (None, "cuda", True, True), (True, "cuda", True, True),
    (False, "cuda", True, False), (None, "cuda", False, False),
    (False, "cuda", False, False),
    (True, "cpu", True, ConfigError), (True, "cuda", False, ConfigError),
])
def test_resolve_cuda_graphs(asked, device, graphable, want):
    """None graphs on a CUDA device unless the trainer's chunk is not
    graphable (AsyncTrainer, the sharded trainers); True where graphs
    cannot run raises."""
    dev = torch.device(device)
    if want is ConfigError:
        with pytest.raises(ConfigError):
            resolve_cuda_graphs(asked, dev, graphable)
    else:
        assert resolve_cuda_graphs(asked, dev, graphable) is want


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    """Two spawned ranks over gloo: what the sharded trainers resolve."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
    import torch_dist_worker as W

    tmp = tmp_path_factory.mktemp("graphable")
    W.launch(tmp, 2, [["graphable", "graphable", {}]], timeout=300)
    return W.results(tmp, "graphable", 2)


@pytest.mark.parametrize("name, backend, want", [
    ("Trainer", None, True), ("AsyncTrainer", None, True),
    ("ShardedTrainer", "nccl", True), ("ShardedAsyncTrainer", "nccl", True),
    ("ShardedTrainer", "gloo", False), ("ShardedAsyncTrainer", "gloo", False),
    ("GSPMDTrainer", None, False),
])
def test_each_trainer_says_whether_it_graphs(name, backend, want, request,
                                             tmp_path, monkeypatch):
    """``graphable``: the plain and async trainers graph; the sharded ones
    exactly when their group's backend is NCCL (gloo collectives cannot be
    captured: two gloo ranks run eagerly and refuse ``cuda_graphs=True``);
    GSPMDTrainer runs eagerly.  The NCCL case is a world of one whose
    backend reads as NCCL; on the CPU it still resolves to eager."""
    import torch.distributed as dist

    from border_tpu_torch import parallel

    cls = {"Trainer": Trainer, "AsyncTrainer": AsyncTrainer}.get(name) or getattr(
        parallel, name)
    if backend is None:
        assert cls.graphable is want
        return
    if backend == "gloo":
        for rank in request.getfixturevalue("gloo_ranks"):
            assert bool(rank[f"{name}/graphable"]) is want
            assert not rank[f"{name}/cuda_graphs"] and rank[f"{name}/true_raises"]
        return
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
        tr = cls(make("CartPole-v1"), DQN(), ReplayBuffer(64, device="cpu"),
                 TrainerConfig(num_envs=4, batch_size=4), device="cpu")
        assert tr.graphable is want and tr.cuda_graphs is False
    finally:
        dist.destroy_process_group()


# -- the helpers of a graphed body ---------------------------------------------

@dataclasses.dataclass
class _S:
    a: torch.Tensor
    nested: dict
    gen: object = None
    k: int = 0


def test_copy_into_writes_every_tensor_in_place():
    dst = _S(torch.zeros(3), {"x": torch.zeros(2, dtype=torch.int32)})
    a, x = dst.a, dst.nested["x"]
    src = _S(torch.arange(3.0), {"x": torch.tensor([4, 5], dtype=torch.int32)})
    copy_into(dst, src)
    assert dst.a is a and dst.nested["x"] is x
    assert torch.equal(a, torch.arange(3.0)) and x.tolist() == [4, 5]


@pytest.mark.parametrize("bad", ["shape", "dtype", "host"])
def test_copy_into_refuses_what_a_graph_would_get_wrong(bad):
    dst = _S(torch.zeros(3), {"x": torch.zeros(2)})
    src = _S(torch.zeros(3), {"x": torch.zeros(2)})
    if bad == "shape":
        src.a = torch.zeros(4)
    elif bad == "dtype":
        src.nested["x"] = torch.zeros(2, dtype=torch.float64)
    else:
        src.k = 1
    with pytest.raises(GraphCaptureError):
        copy_into(dst, src)


def test_add_metrics_sums_in_place_and_refuses_host_values():
    sums = {}
    add_metrics_(sums, {"loss": torch.tensor(1.5)})
    held = sums["loss"]
    add_metrics_(sums, {"loss": torch.tensor(2.0)})
    assert sums["loss"] is held and held.item() == 3.5
    with pytest.raises(GraphCaptureError, match="epsilon"):
        add_metrics_(sums, {"epsilon": 0.5})


@pytest.mark.parametrize("cuda_graphs", [False, True])
def test_a_loop_runs_its_body_eagerly_or_as_replays(cuda_graphs, monkeypatch):
    """The one runner of every loop body, on a fake body.  Without graphs
    ``run(n)`` calls the body ``n`` times and records nothing (no counts,
    no nodes, no graph), and its sums take a host value.  With graphs
    (torch.cuda's stream and graph calls faked on the CPU, a replay calling
    the body) it warms up ``WARMUP`` times, captures once, replays the
    rest and counts each, and a host metric raises.  ``run(0)`` does
    nothing; ``bound_loop`` keeps a loop for the same objects and makes a
    new one for others."""
    calls = []

    def step(loop):
        calls.append(loop)
        loop.add_metrics({"loss": torch.tensor(2.0)})

    class FakeGraph:
        def __init__(self, keep_graph=False):
            pass

        def register_generator_state(self, gen):
            pass

        def instantiate(self):
            pass

        def replay(self):
            step(loop)

    class FakeStream:
        def wait_stream(self, other):
            pass

    if cuda_graphs:
        monkeypatch.setattr(torch.cuda, "Stream", FakeStream)
        monkeypatch.setattr(torch.cuda, "current_stream", FakeStream)
        monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
        monkeypatch.setattr(torch.cuda, "graph",
                            lambda g, stream=None: contextlib.nullcontext())
        monkeypatch.setattr(graphs, "kernel_nodes", lambda g: 7)
    monkeypatch.setattr(graphs, "counts", collections.Counter())
    monkeypatch.setattr(graphs, "nodes", {})
    name, a, b, gen = "fake loop", object(), object(), torch.Generator()
    cache = {}
    loop = bound_loop(cache, name, (a, b), step, [gen], cuda_graphs, updates=1)
    assert bound_loop(cache, name, (a, b), step, [gen], cuda_graphs) is loop
    loop.run(0)
    assert not calls and not loop.sums and not graphs.counts

    loop.run(5)
    loop.run(2)
    if cuda_graphs:
        # 3 warm-ups, the capture's one call, 2 + 2 replays
        assert len(calls) == graphs.WARMUP + 1 + 4
        assert dict(graphs.counts) == {(name, "warmups"): 3, (name, "captures"): 1,
                                       (name, "replays"): 4}
        assert graphs.nodes == {name: (7, 1)} and loop.graph is not None
        assert loop.sums["loss"].item() == 4.0  # zeroed by the second run
    else:
        assert len(calls) == 7 and calls[0] is loop
        assert not graphs.counts and not graphs.nodes and loop.graph is None
        assert loop.sums["loss"].item() == 4.0
    other = bound_loop(cache, name, (a, object()), step, [gen], cuda_graphs)
    assert other is not loop and cache[name] is other

    host = bound_loop(cache, "host metric", (a,),
                      lambda lp: lp.add_metrics({"epsilon": 0.25}), [gen],
                      cuda_graphs)
    if cuda_graphs:
        with pytest.raises(GraphCaptureError, match="epsilon"):
            host.run(1)
    else:
        host.run(3)
        assert host.sums == {"epsilon": 0.75}


def test_counted_wrappers_count_captures_apart():
    """The gather counts launches and captured launches apart; on the CPU
    it launches no kernel and counts nothing."""
    assert gather_frames in COUNTED
    before = (gather_frames.launches, gather_frames.captured)
    gather_frames(torch.zeros(4, 2, 2, dtype=torch.uint8),
                  torch.zeros(1, 2, dtype=torch.int32))
    assert (gather_frames.launches, gather_frames.captured) == before


class _Cycle:
    """An object in a reference cycle: only the collector frees it."""

    freed = 0

    def __init__(self):
        self.me = self

    def __del__(self):
        _Cycle.freed += 1


@pytest.mark.parametrize("enabled", [True, False])
@pytest.mark.parametrize("raises", [False, True])
def test_no_collection_collects_first_then_holds_the_collector(enabled, raises):
    """A capture's guard: the cyclic garbage made before it is freed on
    entry, none made inside it is freed there (an allocation past the
    threshold starts no collection), and the collector's switch is as it
    was after the block, also when the block raises."""
    was = gc.isenabled()
    threshold = gc.get_threshold()
    (gc.enable if enabled else gc.disable)()
    gc.set_threshold(1)
    try:
        _Cycle()
        freed = _Cycle.freed
        with pytest.raises(RuntimeError) if raises else contextlib.nullcontext():
            with no_collection():
                assert _Cycle.freed == freed + 1 and not gc.isenabled()
                _Cycle()
                junk = [[i] for i in range(1_000)]  # past the threshold
                assert _Cycle.freed == freed + 1 and junk
                if raises:
                    raise RuntimeError("a failed capture")
        assert gc.isenabled() == enabled
        gc.collect()
        assert _Cycle.freed == freed + 2
    finally:
        gc.set_threshold(*threshold)
        (gc.enable if was else gc.disable)()


# -- the card's counter formulation, on CPU tensors ----------------------------

@pytest.mark.parametrize("n", [0, 1, 999, 50_000, 100_000, 10**7])
def test_linear_schedule_of_a_count_tensor_equals_the_host_one(n):
    host = linear_f32(n, 100_000, 1.0, 0.02)
    dev = linear_f32(torch.tensor(n), 100_000, 1.0, 0.02)
    assert dev.dtype == torch.float32 and dev.shape == ()
    assert dev.item() == host
    beta = PerConfig(n_opts_final=100_000)
    assert beta.beta(torch.tensor(n)).item() == beta.beta(n)


@pytest.mark.parametrize("n", [0, 1, 37, 500, 999, 1000, 5000])
def test_cosine_schedule_of_a_count_tensor_matches_the_host_one(n):
    sched = cosine_decay_schedule(1e-3, 1000, alpha=0.1)
    host, dev = np.float32(sched(n)), sched(torch.tensor(n))
    assert dev.dtype == torch.float32 and dev.shape == ()
    assert abs(dev.item() - host) <= 2 * np.spacing(host)


def test_dqn_rate_of_a_count_tensor_is_the_host_rate_in_float32():
    agent = DQN(DQNConfig(lr=1e-3, lr_decay_steps=64, lr_final_frac=0.05))
    for n in (0, 1, 17, 63, 64, 1000):
        host = agent._lr(n)
        # float32's start + frac·(end − start): within 2 ulps of the start
        assert agent._lr(torch.tensor(n)).item() == pytest.approx(
            host, rel=0, abs=2 * float(np.spacing(np.float32(1e-3))))


@pytest.mark.parametrize("interval, tau", [(1, 0.005), (3, 1.0), (4, 0.3)])
def test_masked_polyak_equals_the_branch(interval, tau):
    """On a device count the target update runs every step with τ masked
    to 0 off the sync steps: the same values as the host branch."""
    g = torch.Generator().manual_seed(0)
    online = torch.nn.Linear(5, 3)
    targets = [torch.nn.Linear(5, 3) for _ in range(2)]
    for t in targets:
        t.load_state_dict(targets[0].state_dict())
    for n in range(1, 9):
        with torch.no_grad():
            for p in online.parameters():
                p.add_(torch.randn(p.shape, generator=g))
        periodic_polyak(n, interval, tau, online, targets[0])
        periodic_polyak(torch.tensor(n), interval, tau, online, targets[1])
        for a, b in zip(*(t.parameters() for t in targets)):
            assert torch.equal(a, b), n


def test_sync_counters_sets_the_host_mirrors():
    buf = ReplayBuffer(8, device="cpu")
    st = _with_counts(buf.init(Transition(torch.zeros(2), torch.zeros(()),
                                          torch.zeros(2), torch.zeros(()),
                                          torch.zeros((), dtype=torch.bool),
                                          torch.zeros((), dtype=torch.bool))))
    st.counts.copy_(torch.tensor([5, 8]))
    agent_state = DQN().init(0, spaces.Box(-1.0, 1.0, (4,)),
                             spaces.Discrete(2), device="cpu")
    _with_counts(agent_state).counts.copy_(torch.tensor([7, 70]))
    sync_counters(agent_state, st, None)
    assert (st.cursor, st.size) == (5, 8)
    assert (agent_state.n_opts, agent_state.n_samples) == (7, 70)


def test_randint_below_covers_the_range():
    g = torch.Generator().manual_seed(0)
    x = randint_below(torch.tensor(7), (4096,), g)
    assert x.dtype == torch.int64 and x.min() == 0 and x.max() == 6
    counts = torch.bincount(x, minlength=7).float()
    assert (counts / counts.mean() - 1).abs().max() < 0.15


def _frame_pushes(bufs, states, steps, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    ep = torch.zeros(n, dtype=torch.int32)
    for _ in range(steps):
        obs = torch.randint(0, 256, (n, 84, 84, 4), generator=g, dtype=torch.uint8)
        act = torch.randint(0, 6, (n,), generator=g, dtype=torch.int32)
        term = torch.rand(n, generator=g) < 0.2
        ts = types.SimpleNamespace(reward=torch.rand(n, generator=g),
                                   terminated=term,
                                   truncated=torch.zeros(n, dtype=torch.bool))
        for b, st in zip(bufs, states):
            b.process_step(st, obs, act, ts, ep)
        ep = torch.where(term, 0, ep + 1).to(torch.int32)


@pytest.mark.parametrize("kw", [{}, dict(sample_mode="slice", slice_group=4),
                                dict(per=PerConfig(n_opts_final=50)),
                                dict(n_step=3)])
def test_frame_buffer_card_path_equals_host_path(kw):
    """The frame buffer's pushes at the device count's slot (index copies,
    the slice mode's mirror slot, the tree's residency push) give the host
    path's ring and tree; its draw range is the host one, and the same
    injected draws give the same batch."""
    n, cap = 8, 16
    bufs = [FrameReplayBuffer(cap, n, device="cpu", **kw) for _ in range(2)]
    states = [bufs[0].init(), _with_counts(bufs[1].init())]
    _frame_pushes(bufs, states, cap + 5, n)
    host, card = states
    assert card.total == host.total == cap + 5 and card.counts.tolist() == [cap + 5]
    for f in ("frames", "act", "reward", "terminated", "truncated", "age"):
        assert torch.equal(getattr(card, f), getattr(host, f)), f
    if "per" in kw:
        for f in ("sum_tree", "min_tree", "max_priority"):
            assert torch.equal(getattr(card.tree, f), getattr(host.tree, f)), f
        u = torch.rand(32, generator=torch.Generator().manual_seed(1))
        e0, s0, w0 = bufs[0].draw_per(host, None, 32, n_opts=10, u=u)
        e1, s1, w1 = bufs[1].draw_per(card, None, 32, n_opts=torch.tensor(10),
                                      u=u)
        assert torch.equal(e0, e1) and torch.equal(s0, s1)
        torch.testing.assert_close(w1, w0, rtol=1e-6, atol=0)
        return
    lo, hi = bufs[0]._draw_range(host)
    lo_t, hi_t = bufs[1]._draw_range(card)
    assert (lo_t.item(), hi_t.item()) == (lo, hi)
    g = torch.Generator().manual_seed(2)
    _, s = bufs[1].draw(card, g, 512)
    assert s.min() == lo and s.max() == hi - 1
    e, s = bufs[0].draw(host, torch.Generator().manual_seed(3), 64)
    a, b = bufs[0].sample_at(host, e, s), bufs[1].sample_at(card, e, s)
    for f in ("obs", "next_obs", "act", "reward", "terminated", "ix_sample"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("kw", [{}, dict(n_step=3, stride=8),
                                dict(per=PerConfig(n_opts_final=100))])
def test_flat_buffer_card_path_equals_host_path(kw):
    """The flat ring's pushes at the device cursor (wrapping), its device
    draw ranges and its prioritized draws against the host path."""
    bufs = [ReplayBuffer(64, device="cpu", **kw) for _ in range(2)]
    z, flag = torch.zeros(3), torch.zeros((), dtype=torch.bool)
    example = Transition(z, torch.zeros((), dtype=torch.int32), z,
                         torch.zeros(()), flag, flag)
    states = [bufs[0].init(example), _with_counts(bufs[1].init(example))]
    g = torch.Generator().manual_seed(0)
    for _ in range(11):  # 88 transitions: the ring wraps
        batch = Transition(
            obs=torch.rand((8, 3), generator=g),
            act=torch.randint(0, 3, (8,), generator=g, dtype=torch.int32),
            next_obs=torch.rand((8, 3), generator=g),
            reward=torch.rand((8,), generator=g),
            terminated=torch.rand((8,), generator=g) < 0.1,
            truncated=torch.zeros((8,), dtype=torch.bool))
        for b, st in zip(bufs, states):
            b.push(st, batch)
    host, card = states
    assert card.counts.tolist() == [host.cursor, host.size] == [88 % 64, 64]
    for f in ("obs", "act", "next_obs", "reward", "terminated"):
        assert torch.equal(getattr(card.data, f), getattr(host.data, f)), f
    if "per" in kw:
        u = torch.rand(16, generator=g)
        i0, w0 = bufs[0].draw_per(host, None, 16, n_opts=30, u=u)
        i1, w1 = bufs[1].draw_per(card, None, 16, n_opts=torch.tensor(30), u=u)
        assert torch.equal(i0, i1)
        torch.testing.assert_close(w1, w0, rtol=1e-6, atol=0)
        return
    lo = 16 if "n_step" in kw else 0
    raw = torch.randint(lo, 64, (32,), generator=g)
    i0, i1 = bufs[0].draw(host, None, 32, raw=raw), bufs[1].draw(card, None, 32, raw=raw)
    assert torch.equal(i0, i1)
    a, b = bufs[0].sample_at(host, i0), bufs[1].sample_at(card, i1)
    for f in ("obs", "act", "next_obs", "reward", "terminated", "ix_sample"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    drawn = bufs[1].draw(card, torch.Generator().manual_seed(4), 2048)
    if "n_step" in kw:  # d ∈ [16, 64) before the cursor
        d = (card.cursor - 1 - drawn) % 64
        assert d.min() == 16 and d.max() == 63
    else:
        assert drawn.min() == 0 and drawn.max() == 63


def test_dqn_update_on_count_tensors_equals_host_counts():
    """A DQN state with device counters (ε, the target cadence and the
    counters read from the tensor) and one without make the same updates,
    actions and counters, with ε a tensor of the host value."""
    obs_space, act_space = spaces.Box(-1.0, 1.0, (4,)), spaces.Discrete(3)
    agent = DQN(DQNConfig(hidden=(16,), soft_update_interval=3, tau=1.0,
                          eps_final_step=40))
    states = [agent.init(0, obs_space, act_space, device="cpu"),
              _with_counts(agent.init(0, obs_space, act_space, device="cpu"))]
    g = torch.Generator().manual_seed(0)
    for _ in range(7):
        batch = TransitionBatch(
            obs=torch.randn((16, 4), generator=g),
            act=torch.randint(0, 3, (16,), generator=g, dtype=torch.int32),
            next_obs=torch.randn((16, 4), generator=g),
            reward=torch.randn((16,), generator=g),
            terminated=torch.rand((16,), generator=g) < 0.2,
            truncated=torch.zeros((16,), dtype=torch.bool))
        out = [agent.update(st, batch) for st in states]
        obs = torch.randn((32, 4), generator=g)
        acts = [agent.select_action(st, obs, torch.Generator().manual_seed(9))
                for st in states]
        assert torch.equal(*acts)
        for st in states:
            agent.on_env_step(st, 5)
        (_, m0, td0), (_, m1, td1) = out
        assert torch.equal(td0, td1) and torch.equal(m0["loss"], m1["loss"])
        assert torch.is_tensor(m1["epsilon"]) and m1["epsilon"].item() == m0["epsilon"]
    host, card = states
    for a, b in zip(host.params.parameters(), card.params.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(host.target_params.parameters(), card.target_params.parameters()):
        assert torch.equal(a, b)
    assert card.counts.tolist() == [host.n_opts, host.n_samples] == [7, 35]
    assert count(card, "n_samples").item() == count(host, "n_samples")


def test_softmax_explorer_draws_as_multinomial():
    """The softmax explorer's draw (argmax over exponential draws) is
    ``torch.multinomial``'s own one-sample path: the same actions from the
    same generator state, with no host-side check."""
    agent = DQN(DQNConfig(hidden=(16,), explorer="softmax"))
    st = agent.init(0, spaces.Box(-1.0, 1.0, (4,)), spaces.Discrete(5),
                    device="cpu")
    obs = torch.randn((256, 4), generator=torch.Generator().manual_seed(1))
    got = agent.select_action(st, obs, torch.Generator().manual_seed(2))
    p = torch.softmax(st.params(obs), -1)
    want = torch.multinomial(p, 1, generator=torch.Generator().manual_seed(2))
    assert got.dtype == torch.int32 and torch.equal(got.long(), want[:, 0])


def test_a_state_saved_without_counts_restores_them_from_its_host_ints():
    """A state saved on the CPU (no device counters) restored into a state
    that has them (as on the card): the counters come from the saved host
    ints, copied into the template's own tensor."""
    from border_tpu_torch.utils.checkpoint import pack_state, unpack_state

    agent = DQN(DQNConfig(hidden=(8,)))
    obs_space, act_space = spaces.Box(-1.0, 1.0, (4,)), spaces.Discrete(2)
    saved = agent.init(0, obs_space, act_space, device="cpu")
    saved.n_opts, saved.n_samples = 7, 70
    template = _with_counts(agent.init(1, obs_space, act_space, device="cpu"))
    held = template.counts
    got = unpack_state(template, pack_state(saved))
    assert got.counts is held and held.tolist() == [7, 70]
    assert (got.n_opts, got.n_samples) == (7, 70)


# -- the restructured loops, on the CPU ----------------------------------------

class _RandomPolicy:
    """An agent whose greedy action is a draw from the evaluation's
    generator: what the action generator's seeding decides."""

    module = torch.nn.Linear(1, 1)

    def policy_params(self, state):
        return self.module

    def select_action_eval(self, state, obs, gen=None):
        return torch.randint(0, 2, (obs.shape[0],), generator=gen,
                             dtype=torch.int32)


@pytest.mark.parametrize("kind", ["device", "host"])
def test_evaluations_0_1_0_equal_fresh_evaluators(kind):
    """One evaluator's evaluations 0, 1, 0 (its reset and action
    generators re-seeded in place) against a fresh evaluator each: the same
    records."""
    def build():
        if kind == "device":
            return Evaluator(make("CartPole-v1"), 4, 60, device="cpu")
        return HostEvaluator("CartPole-v1", 4, 60)

    ev, policy = build(), _RandomPolicy()
    got = [dict(ev.evaluate(policy, None, eval_index=i)[1].items())
           for i in (0, 1, 0)]
    want = [dict(build().evaluate(policy, None, eval_index=i)[1].items())
            for i in (0, 1, 0)]
    assert got == want and got[0] == got[2] and got[0] != got[1]


def test_reset_with_index_reseeds_a_given_generator():
    """``gen=``: the resets land in that generator, re-seeded in place,
    and equal the fresh generator's."""
    from border_tpu_torch.core.env import VecEnv

    vec = VecEnv(make("CartPole-v1"), 3, device="cpu")
    gen = torch.Generator()
    a = vec.reset_with_index(7, 3, gen=gen)
    b, c = vec.reset_with_index(7, 4, gen=gen), vec.reset_with_index(7, 3, gen=gen)
    assert a.gen is gen and b.gen is gen and c.gen is gen
    assert torch.equal(a.obs, c.obs) and not torch.equal(a.obs, b.obs)
    fresh = vec.reset_with_index(7, 3)
    assert fresh.gen is not gen and torch.equal(fresh.obs, c.obs)
    assert torch.equal(torch.rand(4, generator=fresh.gen), torch.rand(4, generator=gen))


class _HostSpec:
    """The host-env interface HostEnvTrainer reads at construction."""

    def __init__(self, n, shape, dtype):
        self.num_envs = n
        self.observation_space = spaces.Box(0, 255, shape, dtype)
        self.action_space = spaces.Discrete(3)


@pytest.mark.parametrize("frame", [True, False])
def test_host_device_step_pushes_then_advances_as_before(frame):
    """The device step in its new order (push the transition from the
    fixed obs, then advance the obs in place, then select into the fixed
    action tensor) against the old order (advance a new stack from the
    previous one, push the previous one): the same ring, the same obs and
    the same actions at every step, episodes ending among them."""
    from border_tpu_torch.train.host import HostIO

    n, steps = 4, 14
    shape = (84, 84, 4) if frame else (5,)
    dtype = torch.uint8 if frame else torch.float32
    from border_tpu_torch.models import AtariCNN

    agent = DQN(DQNConfig(model=lambda a: AtariCNN(a, dtype=torch.float32))
                if frame else DQNConfig(hidden=(8,)))

    def buffer():
        return (FrameReplayBuffer(16, n, device="cpu") if frame
                else ReplayBuffer(64, device="cpu"))

    tr = HostEnvTrainer(_HostSpec(n, shape, dtype), agent, buffer(),
                        TrainerConfig(num_envs=n), device="cpu")
    old_buf = buffer()
    obs_space = spaces.Box(-1.0, 1.0, (5,)) if not frame else tr.observation_space
    st = agent.init(0, obs_space, tr.action_space, device="cpu")
    ex = example_transition(obs_space, tr.action_space, "cpu")
    bs, old_bs = tr.buffer.init(ex), old_buf.init(ex)
    rng = np.random.RandomState(0)
    np_dtype = np.uint8 if frame else np.float32

    def obs_batch():
        return (rng.randint(0, 256, (n, *shape)) if frame
                else rng.randn(n, *shape)).astype(np_dtype)

    io = HostIO(torch.device("cpu"))
    obs0 = obs_batch()
    io.upload("obs", obs0)
    gen, old_gen = (torch.Generator().manual_seed(1) for _ in range(2))
    act = tr._select(st, io.dev["obs"], gen)
    old_obs, old_act = torch.as_tensor(obs0), act.clone()
    ep_len = np.zeros(n, np.int32)
    old_gen.set_state(gen.get_state())
    for _ in range(steps):
        obs2, final = obs_batch(), obs_batch()
        term, trunc = rng.rand(n) < 0.2, rng.rand(n) < 0.1
        step = (obs2, final, rng.randn(n).astype(np.float32), term, trunc)
        tr._stage(io, step, ep_len)
        tr._device_step(st, bs, io, act, gen)
        # the old order: advance from the previous obs, then push it
        rew, t_, u_ = (torch.as_tensor(x) for x in step[2:])
        if frame:
            new_obs = tr._advance_stack(
                old_obs, torch.as_tensor(np.ascontiguousarray(obs2[..., -1])), t_ | u_)
            final_t = None
        else:
            new_obs, final_t = torch.as_tensor(obs2), torch.as_tensor(final)
        ts = Timestep(obs=None, final_obs=final_t, reward=rew, terminated=t_,
                      truncated=u_, info={})
        old_buf.process_step(old_bs, old_obs, old_act, ts, torch.as_tensor(ep_len))
        old_obs = new_obs
        old_act = tr._select(st, old_obs, old_gen)
        assert torch.equal(io.dev["obs"], old_obs) and torch.equal(act, old_act)
        ep_len = np.where(term | trunc, 0, ep_len + 1).astype(np.int32)
    for (path, a), (_, b) in zip(_leaves(bs), _leaves(old_bs)):
        if torch.is_tensor(a):
            assert torch.equal(a, b), path
        else:
            assert a == b, path


def test_host_io_refuses_a_changed_array():
    from border_tpu_torch.train.host import HostIO

    io = HostIO(torch.device("cpu"))
    held = io.upload("x", np.zeros(3, np.float32))
    assert io.upload("x", np.ones(3, np.float32)) is held and held.tolist() == [1, 1, 1]
    with pytest.raises(ValueError, match="changed"):
        io.upload("x", np.zeros(4, np.float32))
    with pytest.raises(ValueError, match="changed"):
        io.upload("x", np.zeros(3, np.float64))


def test_sync_policy_into_refreshes_a_persistent_state():
    """``sync_policy(..., into=)`` sets the fields of a state that
    persists: the same object, the given policy, every other field and the
    host counters taken from the source."""
    agent = DQN(DQNConfig(hidden=(8,)))
    obs, act = spaces.Box(-1.0, 1.0, (4,)), spaces.Discrete(2)
    learner = agent.init(0, obs, act, device="cpu")
    stale = agent.init(1, obs, act, device="cpu").params
    actor = agent.sync_policy(learner, stale)
    learner.n_opts, learner.n_samples = 5, 40
    assert agent.sync_policy(learner, stale, into=actor) is actor
    assert actor.params is stale and actor.opt_state is learner.opt_state
    assert (actor.n_opts, actor.n_samples) == (5, 40)
    agent.on_env_step(actor, 8)
    back = agent.sync_policy(actor, learner.params, into=learner)
    assert back is learner and learner.params is not stale and learner.n_samples == 48


def test_async_actor_state_persists_across_chunks():
    """AsyncTrainer acts on one actor state object in every chunk (a graph
    holds it on the card), refreshed from the learner's."""
    agent = DQN(DQNConfig(hidden=(16,)))
    cfg = TrainerConfig(max_opts=24, warmup_period=64, opt_interval=16,
                        batch_size=16, num_envs=8, steps_per_chunk=8, seed=3,
                        sync_interval=8)
    tr = AsyncTrainer(make("CartPole-v1"), agent, ReplayBuffer(512, device="cpu"),
                      cfg, device="cpu")
    acted = []
    select = agent.select_action
    agent.select_action = lambda state, obs, gen: (
        acted.append(state), select(state, obs, gen))[1]
    r = tr.train()
    assert r.opt_steps == 24 and len(acted) == 7 * 8
    assert all(s is tr._actor_state for s in acted)
    assert r.agent_state.n_samples == tr._actor_state.n_samples == 7 * 8 * 8
