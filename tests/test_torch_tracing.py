"""The port's spans and chunk records (``border_tpu_torch.utils.profiling``)
and the benchmark's readers of them (``portbench/metrics/``).

On the CPU: the span tree, a small trainer's chunk records, the flags of
chunks that built a graph or ran under a profiler, the level ``off``, the
ring's bound and ``write_chunks``, ``metrics_to_host`` called from outside
the trainer, the gap and the captured update split over stand-in events
(the CPU has none), and each reader.  On the card (marked ``cuda``, skipped
here): the events' device times, no capture after set-up, the update graph
of an untraced run equal to a traced one's (its kernel nodes, DQN's at
``chunk`` and SAC's at ``detail``), and the ``detail`` split against the
update phase.

This file imports no JAX, so on the GPU machine it runs as

    python -m pytest tests/test_torch_tracing.py -m cuda --noconftest -q
"""

import collections
import importlib.util
import json
import statistics
from pathlib import Path

import pytest
import torch

from border_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
READERS = {  # metric: the record's value it takes the median of
    "span_env_step_ms": lambda r: r["device_ms"]["chunk.env"] / r["vec_steps"],
    "span_update_ms": lambda r: r["device_ms"]["chunk.update"] / r["updates"],
    "chunk_gap_ms": lambda r: r["gap_ms"],
    "first_launch_ms": lambda r: r["first_launch_ms"],
}


@pytest.fixture(autouse=True)
def _fresh_tracer():
    """Each test starts from no records at the default level."""
    old = profiling.set_level("chunk")
    profiling.reset()
    yield
    profiling.set_level(old)
    profiling.reset()


class _Event:
    """A stand-in for a timed CUDA event: its time is a host counter."""

    clock = [0.0]

    def __init__(self, done=True):
        self.t, self.done = self.clock[0], done

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done, "read before it completed"
        return end.t - self.t


@pytest.fixture
def events(monkeypatch):
    """Phase spans record stand-in events at the times ``tick`` sets."""
    made = []

    def event(external=False):
        made.append(_Event())
        return made[-1]

    def tick(ms):
        _Event.clock[0] += ms

    _Event.clock[0] = 0.0
    monkeypatch.setattr(profiling, "_event", event)
    return made, tick


def _chunk(tick, env_ms=2.0, update_ms=3.0, updates=4):
    with profiling.chunk(8, 16, updates):
        with profiling.span("chunk.env", cuda=True):
            tick(env_ms)
        with profiling.span("chunk.update", cuda=True):
            tick(update_ms)


def _cpu_trainer():
    from border_tpu_torch.agents import DQN, DQNConfig
    from border_tpu_torch.envs import make
    from border_tpu_torch.replay import ReplayBuffer
    from border_tpu_torch.train import Trainer, TrainerConfig

    cfg = TrainerConfig(num_envs=4, steps_per_chunk=4, batch_size=8,
                        opt_interval=8, warmup_period=0)
    return Trainer(make("CartPole-v1"), DQN(DQNConfig(hidden=(16,), lr=1e-3)),
                   ReplayBuffer(256, device="cpu"), cfg, device="cpu")


class _Loop:
    """The training loop's body on one trainer's states (the benchmark's
    window): the chunk, then its metrics to the host."""

    def __init__(self, tr):
        self.tr = tr
        self.states = tr.init_states(0, 1)
        self.gen = tr._loop_generator(0)

    def run(self, n, sync=True):
        from border_tpu_torch.train.trainer import metrics_to_host

        for _ in range(n):
            ag, vec, buf = self.states
            warmed = self.tr._buffer_fill(buf) >= self.tr.config.batch_size
            ag, vec, buf, metrics, ret, cnt = self.tr._dispatch(
                ag, vec, buf, self.gen, warmed)
            if sync:
                metrics_to_host(metrics, ret, cnt)
            self.states = (ag, vec, buf)
        return self


def _reader(name):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- spans -----------------------------------------------------------------------

def test_spans_nest_and_record_their_parents():
    with profiling.span("a"):
        with profiling.span("b", tag="x"):
            with profiling.span("c"):
                pass
        with profiling.span("b"):
            pass
    got = [(s["name"], s["tag"], s["parent"]) for s in profiling.spans()]
    assert got == [("c", None, "b"), ("b", "x", "a"), ("b", None, "a"),
                   ("a", None, None)]
    assert all(s["t1_ns"] >= s["t0_ns"] for s in profiling.spans())
    a, b = profiling.spans()[3], profiling.spans()[1]
    assert a["t0_ns"] <= b["t0_ns"] <= b["t1_ns"] <= a["t1_ns"]
    assert profiling.chunk_records() == []  # no chunk ran


def test_a_span_left_by_an_exception_leaves_the_stack_clean():
    with pytest.raises(RuntimeError):
        with profiling.span("outer"):
            with profiling.span("inner"):
                raise RuntimeError("boom")
    with profiling.span("next"):
        pass
    assert profiling.spans()[-1]["parent"] is None


def test_chunk_records_of_a_small_trainer_run():
    """A CPU trainer's chunks: one record each, with the host time of every
    chunk span and of the metrics copy after it; no device events on the
    CPU, so no device times and no gap."""
    tr = _cpu_trainer()
    _Loop(tr).run(5)
    recs = profiling.chunk_records()
    assert [r["seq"] for r in recs] == list(range(5))
    for r in recs:
        assert (r["vec_steps"], r["envs"]) == (4, 4)
        assert {"chunk", "chunk.env", "metrics_to_host"} <= set(r["host_ms"])
        assert r["host_ms"]["chunk"] >= r["host_ms"]["chunk.env"] > 0
        assert r["device_ms"] == {} and r["gap_ms"] is None
        assert not r["built"] and not r["profiled"]
        assert r["first_launch_ms"] == 0.0
    # the first chunks fill the ring; then every chunk updates
    updating = [r for r in recs if r["updates"]]
    assert updating and all(r["updates"] == tr.updates_per_chunk for r in updating)
    assert all("chunk.update" in r["host_ms"] for r in updating)
    assert "chunk.sync_counters" not in recs[0]["host_ms"]  # eager: no mirrors
    names = {s["name"]: s["parent"] for s in profiling.spans()}
    assert names["chunk.env"] == names["chunk.update"] == "chunk"
    assert names["agent.init"] == names["env.reset"] == "trainer.init_states"
    assert names["buffer.init"] == "trainer.init_states"


def test_metrics_to_host_called_from_outside_joins_the_chunk_record():
    """The benchmark's adapter calls ``_dispatch``, then the module's
    ``metrics_to_host``: the copy lands in the chunk's record, as does
    every outermost span before the next chunk; a nested one adds to its
    parent's."""
    _Loop(_cpu_trainer()).run(2, sync=False)
    assert "metrics_to_host" not in profiling.chunk_records()[-1]["host_ms"]
    from border_tpu_torch.train.trainer import metrics_to_host

    metrics_to_host({"x": torch.ones(())})
    with profiling.span("other"):
        with profiling.span("inner"):
            pass
    metrics_to_host({"x": torch.ones(())})
    rec = profiling.chunk_records()[-1]
    assert {"metrics_to_host", "other"} <= set(rec["host_ms"])
    assert "inner" not in rec["host_ms"]
    copies = [s for s in profiling.spans() if s["name"] == "metrics_to_host"]
    assert len(copies) == 2
    assert rec["host_ms"]["metrics_to_host"] == pytest.approx(
        sum(s["t1_ns"] - s["t0_ns"] for s in copies) / 1e6)


@pytest.mark.parametrize("built", [True, False])
def test_a_chunk_that_builds_a_graph_is_flagged(built):
    """A graph's warm-up or capture flags its chunk; its replays do not."""
    for i in range(3):
        with profiling.chunk(1, 1, 1):
            profiling.graph_ran(1000)
            if i == 1:
                profiling.graph_ran(built=built)
    assert [r["built"] for r in profiling.chunk_records()] == [False, built, False]


def test_a_chunk_under_the_profiler_is_flagged_and_annotated():
    """A chunk run under ``torch.profiler`` is flagged, and its spans are
    the profiler's user annotations."""
    from torch.profiler import ProfilerActivity, profile

    loop = _Loop(_cpu_trainer()).run(3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loop.run(1)
    recs = profiling.chunk_records()
    assert [r["profiled"] for r in recs] == [False] * 3 + [True]
    names = {e.name for e in prof.events()}
    assert {"chunk", "chunk.env", "chunk.update", "metrics_to_host"} <= names


def test_level_off_records_nothing_and_costs_one_check():
    profiling.set_level("off")
    assert profiling.span("a") is profiling.span("b", cuda=True)
    assert profiling.chunk(1, 1, 1) is profiling.detail("update.sample")
    assert profiling.span("a").ns is None
    with profiling.span("timed", timed=True) as t:  # its caller reads the ns
        pass
    assert t.ns >= 0
    _Loop(_cpu_trainer()).run(3)
    assert profiling.chunk_records() == [] and profiling.spans() == []
    with pytest.raises(ValueError):
        profiling.set_level("everything")


def test_the_ring_keeps_the_newest_chunks_and_writes_them(tmp_path):
    profiling.reset(chunks_kept=4)
    for _ in range(10):
        with profiling.chunk(2, 3, 5):
            pass
    recs = profiling.chunk_records()
    assert [r["seq"] for r in recs] == [6, 7, 8, 9]
    path = tmp_path / "chunks.jsonl"
    assert profiling.write_chunks(str(path)) == 4
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert lines == recs
    assert lines[0]["vec_steps"] == 2 and lines[0]["updates"] == 5


# -- device times over stand-in events ---------------------------------------------

def test_phase_events_give_device_times_and_the_gap_to_the_next_chunk(events):
    made, tick = events
    _chunk(tick)
    with profiling.span("metrics_to_host"):
        tick(0.5)  # the host's work between the chunks
    _chunk(tick)
    recs = profiling.chunk_records()
    assert [r["device_ms"] for r in recs] == [{"chunk.env": 2.0,
                                               "chunk.update": 3.0}] * 2
    assert recs[0]["gap_ms"] == 0.5
    assert recs[1]["gap_ms"] is None  # the newest: no next chunk yet
    assert len(made) == 8  # four events a chunk
    tick(0.25)
    _chunk(tick)
    assert profiling.chunk_records()[1]["gap_ms"] == 0.25


def test_events_are_read_only_once_complete(events):
    """A record's device times wait for its events (no synchronisation):
    read lazily when a later chunk starts or the records are read."""
    made, tick = events
    _chunk(tick)
    for e in made:
        e.done = False
    assert profiling.chunk_records()[0]["device_ms"] == {}
    _chunk(tick)
    assert profiling.chunk_records()[0]["device_ms"] == {}
    for e in made:
        e.done = True
    rec = profiling.chunk_records()[0]
    assert rec["device_ms"] == {"chunk.env": 2.0, "chunk.update": 3.0}
    assert rec["gap_ms"] == 0.0


@pytest.mark.parametrize("between", ["graph run", "graph built", "profiled"])
def test_other_work_between_two_chunks_leaves_no_gap(events, between):
    """The gap is the device waiting on the host between two chunks of the
    loop: another graph's run or build, or a profiled next chunk, leave it
    unmeasured."""
    _, tick = events
    _chunk(tick)
    if between == "graph run":
        profiling.graph_ran(1000)
    elif between == "graph built":
        profiling.graph_ran(built=True)
    if between == "profiled":
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]):
            _chunk(tick)
    else:
        _chunk(tick)
    assert profiling.chunk_records()[0]["gap_ms"] is None


def test_first_launches_of_a_chunk_are_summed():
    with profiling.chunk(1, 1, 1):
        profiling.graph_ran(2_000_000)
        profiling.graph_ran(500_000)
    assert profiling.chunk_records()[0]["first_launch_ms"] == 2.5


def test_the_captured_split_is_read_from_the_chunk_last_replay(events):
    """Under ``detail`` a captured update's edges are external events that
    every replay records; a chunk's record reads them at its end, after
    its own sync, and leaves them out where they have not completed."""
    _, tick = events
    edges = []
    for name, ms in (("update.sample", 0.1), ("update.forward", 0.7)):
        a = _Event()
        tick(ms)
        edges.append((name, a, _Event()))
    for _ in range(2):
        with profiling.chunk(1, 1, 4):
            profiling.graph_ran(1000, edges)
            profiling.graph_ran(1000, edges)  # one graph's edges, read once
    with profiling.chunk(1, 1, 4):
        profiling.graph_ran(1000)  # a graph without edges
    edges[0][1].done = False
    with profiling.chunk(1, 1, 4):
        profiling.graph_ran(1000, edges)
    recs = profiling.chunk_records()
    for r in recs[:2]:
        assert r["update_split_ms"] == pytest.approx(
            {"update.sample": 0.1, "update.forward": 0.7})
    assert "update_split_ms" not in recs[2] and "update_split_ms" not in recs[3]


def test_detail_level_splits_the_update():
    """``detail``: the update's six spans, in the update phase; at the
    default level none."""
    loop = _Loop(_cpu_trainer()).run(3)
    assert not any(s["name"].startswith("update.") for s in profiling.spans())
    profiling.set_level("detail")
    profiling.reset()
    loop.run(3)
    parents = collections.defaultdict(set)
    for s in profiling.spans():
        parents[s["name"]].add(s["parent"])
    split = ("update.sample", "update.forward", "update.backward",
             "update.optimizer", "update.target", "update.priority")
    assert all(parents[n] == {"chunk.update"} for n in split), dict(parents)
    rec = profiling.chunk_records()[-1]
    assert set(split) <= set(rec["host_ms"])
    assert "update_split_ms" not in rec  # nothing captured on the CPU


def _sac_trainer(device="cpu", hidden=(16, 16), num_envs=4, batch_size=8):
    from border_tpu_torch.agents import SAC, SACConfig
    from border_tpu_torch.envs import make
    from border_tpu_torch.replay import ReplayBuffer
    from border_tpu_torch.train import Trainer, TrainerConfig

    cfg = TrainerConfig(num_envs=num_envs, steps_per_chunk=4, batch_size=batch_size,
                        opt_interval=8, warmup_period=0)
    agent = SAC(SACConfig(actor_hidden=hidden, critic_hidden=hidden))
    return Trainer(make("Pendulum-v1"), agent, ReplayBuffer(256, device=device), cfg,
                   device=device)


SAC_SPLIT = ("update.sample", "update.critic", "update.actor", "update.alpha",
             "update.target", "update.priority", "update.priority")


def test_detail_level_splits_the_sac_update_in_order():
    """SAC's update under ``detail``: the trainer's sample, then the critics'
    step, the actor's, the temperature's, the soft target update and the
    TD error's forward (SAC's, then the trainer's priority write), each
    update in this order; at the default level none."""
    loop = _Loop(_sac_trainer()).run(2)
    assert not any(s["name"].startswith("update.") for s in profiling.spans())
    profiling.set_level("detail")
    profiling.reset()
    loop.run(2)
    split = [s for s in profiling.spans() if s["name"].startswith("update.")]
    assert {s["parent"] for s in split} == {"chunk.update"}
    names = [s["name"] for s in split]
    updates = 2 * loop.tr.updates_per_chunk
    assert names == list(SAC_SPLIT) * updates


@pytest.mark.parametrize("level", ["chunk", "off"])
def test_host_env_trainer_times_its_collect_wait_with_spans(level):
    """The host-env trainer's waits for the envs are spans;
    ``host_wait_frac`` is their share of the record's window, recorded at
    every level (with tracing off the span times itself and records
    nothing)."""
    from border_tpu_torch.agents import DQN, DQNConfig
    from border_tpu_torch.record import BufferedRecorder
    from border_tpu_torch.replay import ReplayBuffer
    from border_tpu_torch.train import HostEnvTrainer, TrainerConfig

    profiling.set_level(level)
    rec = BufferedRecorder()
    tr = HostEnvTrainer("CartPole-v1", DQN(DQNConfig(hidden=(16,), lr=1e-3)),
                        ReplayBuffer(1024, device="cpu"),
                        TrainerConfig(max_opts=8, warmup_period=64, opt_interval=8,
                                      batch_size=16, num_envs=8, steps_per_chunk=2),
                        recorder=rec, device="cpu")
    tr.train()
    waits = [w for k in ("min", "max") for w in rec.scalars(f"host_wait_frac_{k}")]
    assert waits and all(0.0 <= w <= 1.0 for w in waits)
    collects = [s for s in profiling.spans() if s["name"] == "host.collect_wait"]
    if level == "off":
        assert profiling.spans() == []
        return
    assert collects and {s["parent"] for s in collects} == {None}


# -- the benchmark's readers ----------------------------------------------------------

def _record(i, built=False, profiled=False):
    return {"seq": i, "device_ms": {"chunk.env": 10.0 + i, "chunk.update": 40.0 + i},
            "vec_steps": 4, "updates": 8, "gap_ms": 0.1 * i,
            "first_launch_ms": 1.0 + i, "built": built, "profiled": profiled}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_takes_the_window_median_and_needs_three_chunks(metric, monkeypatch):
    read = _reader(metric).read
    few = [_record(0, built=True), _record(1), _record(2), _record(3, profiled=True)]
    monkeypatch.setattr(profiling, "chunk_records", lambda: few)
    assert read({}) is None
    window = [_record(i) for i in range(1, 6)]
    recs = [_record(0, built=True), *window, _record(9, profiled=True)]
    monkeypatch.setattr(profiling, "chunk_records", lambda: recs)
    assert read({}) == pytest.approx(statistics.median(READERS[metric](r)
                                                       for r in window))


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_reads_nothing_from_a_program_without_records(metric, monkeypatch):
    """The parent program keeps no chunk records: the metric is left out."""
    monkeypatch.delattr(profiling, "chunk_records")
    assert _reader(metric).read({}) is None


def test_update_graph_nodes_reads_the_newest_graph_that_makes_updates(monkeypatch):
    from border_tpu_torch.train import graphs

    read = _reader("update_graph_nodes").read
    monkeypatch.setattr(graphs, "nodes", {"env step (explore)": (90, 0)})
    assert read({}) is None
    monkeypatch.setattr(graphs, "nodes", {"update": (236, 1), "env step (explore)": (90, 0),
                                          "sample-batch updates": (600, 4)})
    assert read({}) == 150.0


def test_update_graph_nodes_reads_nothing_from_a_program_without_the_count(monkeypatch):
    from border_tpu_torch.train import graphs

    monkeypatch.delattr(graphs, "nodes")
    assert _reader("update_graph_nodes").read({}) is None


# -- on the card ----------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: chunk events and captured graphs")


def _card_trainer(per=False, batch_size=128):
    from border_tpu_torch.agents import DQN, DQNConfig
    from border_tpu_torch.envs import make
    from border_tpu_torch.models import AtariCNN
    from border_tpu_torch.replay import FrameReplayBuffer, PerConfig
    from border_tpu_torch.train import Trainer, TrainerConfig

    agent = DQN(DQNConfig(model=lambda n: AtariCNN(n), lr=1e-4, double_dqn=True,
                          soft_update_interval=2_000, tau=1.0))
    return Trainer(make("Pong-v0"), agent,
                   FrameReplayBuffer(128, 128, per=PerConfig() if per else None),
                   TrainerConfig(num_envs=128, steps_per_chunk=16,
                                 batch_size=batch_size, opt_interval=32,
                                 warmup_period=0))


@pytest.mark.cuda
def test_chunk_events_give_device_times_on_card():
    _card()
    from border_tpu_torch.train import graphs

    captures = graphs.counts["update", "captures"]
    _Loop(_card_trainer()).run(8)
    recs = profiling.chunk_records()
    assert [r["built"] for r in recs[:2]] == [True, True]
    window = [r for r in recs if not r["built"]]
    assert len(window) == 6
    for r in window:
        assert r["device_ms"]["chunk.env"] > 0 and r["device_ms"]["chunk.update"] > 0
        assert r["first_launch_ms"] > 0
    assert all(r["gap_ms"] is not None and r["gap_ms"] >= 0 for r in window[:-1])
    names = {s["name"] for s in profiling.spans()}
    assert {"graph.warmup", "graph.capture", "chunk.sync_counters"} <= names
    assert graphs.counts["update", "captures"] == captures + 1


@pytest.mark.cuda
def test_no_graph_is_captured_after_set_up_on_card():
    _card()
    from border_tpu_torch.train import graphs

    loop = _Loop(_card_trainer()).run(2)  # set-up: both graphs built
    built = collections.Counter(graphs.counts)
    loop.run(5)
    after = graphs.counts - built
    assert after and all(kind == "replays" for _, kind in after), after
    assert not any(r["built"] for r in profiling.chunk_records()[2:])


def _update_graph_nodes(make_trainer, levels) -> dict:
    """The kernel nodes of the update graph each tracing level's set-up
    captures (``graphs.nodes``, counted at capture: a profiler can lose
    kernel records of a replay)."""
    from border_tpu_torch.train import graphs

    nodes = {}
    for level in levels:
        profiling.set_level(level)
        _Loop(make_trainer()).run(3)
        nodes[level] = graphs.nodes["update"]
    return nodes


@pytest.mark.cuda
@pytest.mark.parametrize("per", [False, True])
def test_tracing_leaves_the_update_graph_unchanged_on_card(per):
    """The update graph captured with chunk tracing on holds the same
    kernel nodes as one captured with tracing off."""
    _card()
    nodes = _update_graph_nodes(lambda: _card_trainer(per), ("off", "chunk"))
    assert nodes["off"] == nodes["chunk"]
    assert nodes["off"][0] > 0 and nodes["off"][1] == 1


@pytest.mark.cuda
def test_the_sac_update_graph_holds_the_same_kernels_at_detail_on_card():
    """SAC's update split at ``detail`` adds only event nodes to its graph:
    its kernel nodes are those of the graph captured with tracing off."""
    _card()
    nodes = _update_graph_nodes(
        lambda: _sac_trainer("cuda", hidden=(256, 256), num_envs=128, batch_size=256),
        ("off", "detail"))
    assert nodes["off"] == nodes["detail"]
    assert nodes["off"][0] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("per", [False, True])
def test_detail_split_sums_to_the_update_phase_on_card(per):
    """Under ``detail`` the six spans' device times of a replay add up to
    the update phase's device time an update, within 10%, at the
    benchmark's batch (the update's metrics, a few small kernels an
    update, lie outside the six spans)."""
    _card()
    profiling.set_level("detail")
    _Loop(_card_trainer(per, batch_size=512)).run(6)
    window = [r for r in profiling.chunk_records()[:-1] if not r["built"]]
    assert window
    for r in window:
        split = r["update_split_ms"]
        assert set(split) == {"update.sample", "update.forward", "update.backward",
                              "update.optimizer", "update.target",
                              "update.priority"}
        per_update = r["device_ms"]["chunk.update"] / r["updates"]
        assert sum(split.values()) == pytest.approx(per_update, rel=0.10), (
            per_update, split)
