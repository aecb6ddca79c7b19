"""Tracing and profiler hooks (≙ border_tpu/utils/profiling.py).

Spans.  ``with span(name):`` records the block's name, its host start and
end (``time.perf_counter_ns``) and the span it opened in, in a ring of the
last :data:`SPANS_KEPT` (:func:`spans`).  A phase span (``cuda=True``)
also records a ``torch.cuda.Event(enable_timing=True)`` on the current
stream at each edge.  While a ``torch.profiler`` is active, every span also
opens ``torch.profiler.record_function(name)``, so the profiler's timeline
(and :func:`profile_trace`'s files) shows the program's spans as user
annotations on the kernels' clock.

Chunks.  :func:`chunk` is the span of one trainer chunk
(``Trainer._chunk``).  Each chunk leaves a record in a ring of the last
:data:`CHUNKS_KEPT` (:func:`chunk_records`, :func:`write_chunks`):

- ``seq``: the chunk's number in the process; ``t_ns``: its host start;
- ``host_ms``: the host milliseconds of every span inside the chunk, and
  of every outermost span between it and the next chunk (the metrics'
  copy to the host), summed per name;
- ``device_ms``: the device milliseconds of its phase spans
  (``chunk.env``, ``chunk.update``), from their events;
- ``gap_ms``: device milliseconds from its last phase event to the next
  chunk's first, the device waiting on the host between chunks; None for
  the newest chunk, and where a graph ran or was built between the two
  chunks or the next chunk ran under a profiler;
- ``vec_steps`` (vector env steps, each stepping ``envs`` envs),
  ``updates``;
- ``first_launch_ms``: host milliseconds of each graph run's first
  replay (:class:`border_tpu_torch.train.graphs.LoopGraph`), summed;
- ``built``: a graph was warmed up or captured in it; ``profiled``: it
  ran under an active profiler;
- ``update_split_ms`` (level ``detail``): the device milliseconds of the
  ``update.*`` spans of the chunk's last replay of a captured update,
  read at the chunk's end, where the chunk's own sync has completed them.

A record's device numbers are read lazily, when a later chunk starts or
the records are read, and only from events that ``query()`` reports
complete: tracing never synchronises.

Levels: ``off`` (a span costs one check and records nothing), ``chunk``
(the default: chunk, set-up and host spans) and ``detail`` (also the
update's split, :func:`detail`).  The level is read from
``BORDER_TPU_TRACE`` at import and set by :func:`set_level`.  Under
``detail`` an update captured into a CUDA graph records an external
event (``external=True``) at each edge of its ``update.*`` spans, so every
replay times them; with ``detail`` off at capture time the graph holds
nothing of the tracing.  Spans are opened from one thread, the training
loop's.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from typing import Deque, Iterator, List, Optional, Sequence

import torch

OFF, CHUNK, DETAIL = 0, 1, 2
LEVELS = {"off": OFF, "chunk": CHUNK, "detail": DETAIL}
CHUNKS_KEPT = 8192
SPANS_KEPT = 65536


def _level_of(name: str) -> int:
    if name not in LEVELS:
        raise ValueError(f"tracing level {name!r} is not one of {sorted(LEVELS)}")
    return LEVELS[name]


def _profiling() -> bool:
    return torch.autograd._profiler_enabled()


def _event(external: bool = False) -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True, external=external)
    ev.record()
    return ev


def _ms(edges: Sequence[tuple]) -> Optional[dict]:
    """``{name: device ms}`` summed over ``(name, start, end)`` events, or
    None while one of them has not completed."""
    if not all(e.query() for _, a, b in edges for e in (a, b)):
        return None
    out: dict = {}
    for name, a, b in edges:
        out[name] = out.get(name, 0.0) + a.elapsed_time(b)
    return out


class Span:
    """One open span; its ``ns`` after the block."""

    __slots__ = ("name", "tag", "parent", "t0", "t1", "cuda", "edges", "_rf")

    def __init__(self, name: str, tag: Optional[str] = None, cuda: bool = False):
        self.name, self.tag, self.cuda = name, tag, cuda
        self.parent: Optional[Span] = None
        self.edges: Optional[tuple] = None
        self._rf = None

    @property
    def ns(self) -> int:
        return self.t1 - self.t0

    def __enter__(self) -> "Span":
        TRACER.open(self)
        if _profiling():
            self._rf = torch.autograd.profiler.record_function(self.name)
            self._rf.__enter__()
        if self.cuda:
            self.edges = (_event(),)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter_ns()
        if self.cuda:
            self.edges += (_event(),)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        TRACER.close(self)
        return False


class _DetailSpan(Span):
    """An ``update.*`` span: host time, and under a CUDA graph's capture
    an external event at each edge, which every replay records."""

    __slots__ = ()

    def __enter__(self) -> "Span":
        self.cuda = self.cuda and torch.cuda.is_current_stream_capturing()
        if self.cuda:
            TRACER.open(self)
            self.edges = (_event(external=True),)
            self.t0 = time.perf_counter_ns()
            return self
        return super().__enter__()

    def __exit__(self, *exc) -> bool:
        if not self.cuda:
            return super().__exit__(*exc)
        self.t1 = time.perf_counter_ns()
        self.edges += (_event(external=True),)
        TRACER.captured.append((self.name, *self.edges))
        TRACER.close(self)
        return False


class _ChunkSpan(Span):
    __slots__ = ("counts",)

    def __init__(self, counts: dict):
        super().__init__("chunk")
        self.counts = counts


class _Off:
    """The span of level ``off``: nothing is recorded."""

    ns = None

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Clock:
    """A ``timed`` span at level ``off``: its ``ns``, and nothing recorded."""

    __slots__ = ("t0", "ns")

    def __enter__(self) -> "_Clock":
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.ns = time.perf_counter_ns() - self.t0
        return False


class _Chunk:
    """A chunk's record and the device events it is still waiting on."""

    __slots__ = ("rec", "phases", "before", "splits")

    def __init__(self, rec: dict, before: Optional[tuple]):
        self.rec = rec
        self.phases: List[tuple] = []  # (name, start event, end event)
        # (the previous chunk's record, its last event): the gap between
        self.before = before
        self.splits: List[Sequence[tuple]] = []  # detail edges of its graphs

    def settle(self) -> bool:
        """Reads its events once all have completed; True then."""
        if self.before is not None and not self.before[1].query():
            return False
        device = _ms(self.phases)
        if device is None:
            return False
        self.rec["device_ms"].update(device)
        if self.before is not None and self.phases:
            prev, end = self.before
            prev["gap_ms"] = end.elapsed_time(self.phases[0][1])
        return True


class Tracer:
    """The process's spans and chunk records (one instance, :data:`TRACER`)."""

    def __init__(self, level: str = "chunk"):
        self.level = _level_of(level)
        self.reset()

    def reset(self, chunks_kept: int = CHUNKS_KEPT) -> None:
        self.stack: List[Span] = []
        self.spans: Deque[tuple] = collections.deque(maxlen=SPANS_KEPT)
        self.chunks: Deque[dict] = collections.deque(maxlen=chunks_kept)
        self.unsettled: List[_Chunk] = []
        self.open_chunk: Optional[_Chunk] = None
        self.last: Optional[dict] = None  # the newest chunk's record
        # the newest chunk's last phase event; None once a graph ran after it
        self.last_end = None
        self.captured: List[tuple] = []  # detail edges of the open capture
        self.seq = 0

    # -- spans -----------------------------------------------------------------
    def open(self, span: Span) -> None:
        span.parent = self.stack[-1] if self.stack else None
        self.stack.append(span)
        if isinstance(span, _ChunkSpan):
            self._begin_chunk(span)

    def close(self, span: Span) -> None:
        if self.stack and self.stack[-1] is span:
            self.stack.pop()
        elif span in self.stack:  # an inner span left open by an exception
            del self.stack[self.stack.index(span):]
        parent = span.parent.name if span.parent is not None else None
        self.spans.append((span.name, span.tag, parent, span.t0, span.t1))
        cur = self.open_chunk
        if isinstance(span, _ChunkSpan):
            self._end_chunk(span)
            return
        if cur is not None:
            if span.cuda and type(span) is Span:  # a phase: its events
                cur.phases.append((span.name, *span.edges))
            rec = cur.rec
        elif parent is None and self.last is not None:
            rec = self.last  # the host's work between two chunks
        else:
            return
        rec["host_ms"][span.name] = rec["host_ms"].get(span.name, 0.0) + span.ns / 1e6

    # -- chunks ----------------------------------------------------------------
    def _begin_chunk(self, span: _ChunkSpan) -> None:
        # events that never complete are given up after 64 chunks
        self.unsettled = [c for c in self.unsettled if not c.settle()][-64:]
        profiled = _profiling()
        before = None
        if self.last_end is not None and not profiled:
            before = (self.last, self.last_end)
        rec = {"seq": self.seq, "t_ns": time.perf_counter_ns(), "host_ms": {},
               "device_ms": {}, "gap_ms": None, **span.counts,
               "first_launch_ms": 0.0, "built": False, "profiled": profiled}
        self.seq += 1
        self.open_chunk = _Chunk(rec, before)
        self.chunks.append(rec)
        self.unsettled.append(self.open_chunk)
        self.last, self.last_end = rec, None

    def _end_chunk(self, span: _ChunkSpan) -> None:
        cur, self.open_chunk = self.open_chunk, None
        rec = cur.rec
        rec["host_ms"]["chunk"] = span.ns / 1e6
        rec["profiled"] = rec["profiled"] or _profiling()
        if cur.phases:
            self.last_end = cur.phases[-1][2]
        splits = [_ms(edges) for edges in cur.splits]
        if splits and None not in splits:
            rec["update_split_ms"] = {k: v for s in splits for k, v in s.items()}

    def graph_ran(self, first_ns: int, edges: Sequence[tuple], built: bool) -> None:
        cur = self.open_chunk
        if cur is None:  # a graph outside the loop: the gap is not the loop's
            self.last_end = None
            return
        cur.rec["first_launch_ms"] += first_ns / 1e6
        cur.rec["built"] = cur.rec["built"] or built
        if edges and all(e is not edges for e in cur.splits):
            cur.splits.append(edges)

    def records(self) -> List[dict]:
        self.unsettled = [c for c in self.unsettled if not c.settle()]
        return [{k: dict(v) if isinstance(v, dict) else v for k, v in r.items()}
                for r in self.chunks]


TRACER = Tracer(os.environ.get("BORDER_TPU_TRACE", "chunk"))


# -- the module's interface ------------------------------------------------------

def set_level(level: str) -> str:
    """Sets the tracing level (``off``, ``chunk``, ``detail``); returns the
    previous one."""
    old = level_name()
    TRACER.level = _level_of(level)
    return old


def level_name() -> str:
    return {v: k for k, v in LEVELS.items()}[TRACER.level]


def span(name: str, tag: Optional[str] = None, cuda: bool = False,
         timed: bool = False):
    """The span of a block (level ``chunk``); ``cuda``: events at its edges
    on the current stream (the chunk's phases); ``tag``: what it works on
    (a graph's name); ``timed``: the caller reads its ``ns``, so at level
    ``off`` the block is still timed (and nothing recorded)."""
    if TRACER.level < CHUNK:
        return _Clock() if timed else _OFF
    return Span(name, tag, cuda)


def detail(name: str, cuda: bool = False):
    """A span of the update's split (level ``detail``); ``cuda``: the
    update's tensors are on a CUDA device (its edges are timed where it
    is captured)."""
    if TRACER.level < DETAIL:
        return _OFF
    return _DetailSpan(name, None, cuda)


def chunk(vec_steps: int, envs: int, updates: int):
    """The span of one chunk: ``vec_steps`` vector env steps of ``envs``
    envs and ``updates`` updates."""
    if TRACER.level < CHUNK:
        return _OFF
    return _ChunkSpan({"vec_steps": vec_steps, "envs": envs, "updates": updates})


def graph_ran(first_ns: int = 0, edges: Sequence[tuple] = (),
              built: bool = False) -> None:
    """A CUDA graph's run.  In a chunk, ``first_ns`` (its first replay's
    host launch) joins the record's ``first_launch_ms``, ``built`` (it was
    warmed up or captured) flags the record, and ``edges``, the detail
    split's ``(name, start, end)`` events its replays record, are read at
    the chunk's end.  Outside a chunk it leaves the newest chunk's gap
    unmeasured."""
    if TRACER.level >= CHUNK:
        TRACER.graph_ran(first_ns, edges, built)


def take_captured() -> List[tuple]:
    """The ``(name, start, end)`` events of the detail spans captured since
    the last call: the capturing graph keeps them as long as it lives."""
    edges, TRACER.captured = TRACER.captured, []
    return edges


def chunk_records() -> List[dict]:
    """The kept chunk records, oldest first (copies)."""
    return TRACER.records()


def write_chunks(path: str) -> int:
    """The chunk records as JSON lines at ``path``; returns their number."""
    recs = chunk_records()
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    return len(recs)


def spans() -> List[dict]:
    """The kept spans, oldest first: name, tag, parent's name, host ns."""
    return [{"name": n, "tag": t, "parent": p, "t0_ns": a, "t1_ns": b}
            for n, t, p, a, b in TRACER.spans]


def reset(chunks_kept: int = CHUNKS_KEPT) -> None:
    """Forgets every span and record (the level stays)."""
    TRACER.reset(chunks_kept)


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a GPU is present) and write a Chrome trace,
    ``<log_dir>/trace_<pid>_<n>.json`` (viewable in Perfetto or
    ``chrome://tracing``); the program's spans are its user annotations.

    No-op when ``log_dir`` is falsy, so call sites can leave it wired.
    """
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the block's kernels end inside the trace
    n = len([f for f in os.listdir(log_dir) if f.startswith("trace_")])
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))
