"""CUDA-graph replay of the trainers' loop bodies (≙ the JAX trainers'
``jax.jit`` over ``lax.scan``).

The JAX trainers compile a chunk's env steps and updates into one XLA
program.  Here one loop body (an env step, an update) is captured into a
CUDA graph and the graph is replayed once per iteration: a replay launches
the body's kernels from the device's copy of the graph, with no Python and
no per-operator host work.

A body reads and writes tensors that keep their addresses: the agent's
modules and optimizer, the replay ring and tree, the counters
(:mod:`border_tpu_torch.utils.counters`) and metric sums are updated in
place, and a functional result (the env's next state) is copied into the
tensors the next iteration reads (:func:`copy_into`).  The generators the
body draws from are registered with the graph, so every replay draws the
values the eager body would draw next: the CUDA generator hands a replay
the offset the eager launches would have had.  So a replayed iteration
computes what the eager body computes, bit for bit, and the eager path on
the card runs the same operations (the same capturable optimizer, the same
device-count draws) for the tests to hold the two against each other.

Each loop body of the trainers and evaluators is written once, as the
step of a :class:`LoopGraph`, and its owner's resolved ``cuda_graphs``
(:func:`resolve_cuda_graphs`) decides how the loop runs it.  Without
graphs (the CPU, ``cuda_graphs=False``) ``run(n)`` calls the step ``n``
times on the current stream.  With graphs it runs the step eagerly for its
first ``WARMUP`` iterations (on a side stream, as capture asks: lazy state
such as the optimizer's moments and the kernels' libraries is made then),
captures it on its next, and replays it from then on.  A capture that
fails raises :class:`GraphCaptureError` naming the operator that broke it;
nothing falls back to the eager body.  No collection of the cyclic
garbage collector runs inside a capture (:func:`no_collection`): an
object in a dead reference
cycle can hold a captured graph (a trainer's or an evaluator's graphs hold
their owner through the body), and destroying a graph while another
stream is capturing invalidates that capture, so the collector runs just
before the capture instead.  Each replay adds the kernel launches its capture
recorded to the counted wrappers' ``launches``
(:data:`border_tpu_torch.ops.COUNTED`) and the collectives it recorded
(an update's gradient all-reduce under NCCL) to
:data:`border_tpu_torch.utils.collectives.counts`, and :data:`counts`
counts every graph's warm-up iterations, captures and replays by name.
The warm-up and the capture are the spans ``graph.warmup`` and
``graph.capture``, and a run's first replay is timed on the host
(:mod:`border_tpu_torch.utils.profiling`).  At its capture a graph's kernel
nodes are counted once (libcuda's ``cuGraphGetNodes`` over the captured
``cudaGraph_t``) into :data:`nodes`, with the agent updates its body makes:
a replay launches every node, and a profiler can lose some of a replay's
kernel records.

``run(n)`` takes any ``n`` from call to call: a host-env iteration replays
its device step once and its update burst as often as the iteration's
share of updates, and an evaluation replays its env step in blocks of up
to 8.  A generator the body draws from may be re-seeded in place between
runs (``manual_seed`` or ``set_state``, as a checkpoint restore does): the
graph holds the generator's state, so its next replay draws from the new
seed.  A new generator object would need a new capture.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from border_tpu_torch.errors import BorderTpuError, ConfigError
from border_tpu_torch.ops import COUNTED
from border_tpu_torch.utils import collectives, profiling

WARMUP = 3
# ``counts[(graph name, "warmups" | "captures" | "replays")]``: the eager
# warm-up iterations, captures and replays of every LoopGraph so far; a
# capture counted after set-up names the graph that was built again
counts: collections.Counter = collections.Counter()
# ``nodes[graph name] = (kernel nodes, updates)``: the kernel nodes of the
# graph's newest capture and the agent updates one iteration of its body
# makes (0 for an env step); the newest capture is the last entry
nodes: Dict[str, tuple] = {}
CU_GRAPH_NODE_TYPE_KERNEL = 0


class GraphCaptureError(BorderTpuError, RuntimeError):
    """A loop body could not be captured into a CUDA graph."""


def resolve_cuda_graphs(cuda_graphs: Optional[bool], device: torch.device,
                        graphable: bool = True, owner: str = "Trainer") -> bool:
    """The ``cuda_graphs`` switch of a trainer or an evaluator on
    ``device``: None means on a CUDA device; True raises on the CPU and for
    an ``owner`` whose loop is not graphable (``graphable``), which then
    runs eagerly."""
    if cuda_graphs and device.type != "cuda":
        raise ConfigError(f"cuda_graphs=True needs a CUDA device, not {device}")
    if cuda_graphs and not graphable:
        raise ConfigError(f"{owner} runs its chunk eagerly: cuda_graphs=True "
                          f"is not available")
    if cuda_graphs is None:
        return graphable and device.type == "cuda"
    return bool(cuda_graphs)


def _leaves(x: Any, path: str = ""):
    """``(path, leaf)`` of a (nested) dataclass, dict or tensor."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name), f"{path}.{f.name}")
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    else:
        yield path, x


def copy_into(dst: Any, src: Any) -> None:
    """Every tensor of ``src`` copied into the tensor at its place in
    ``dst`` (a nested dataclass or dict of the same structure), in one
    ``_foreach_copy_``: a functional step's result written where the next
    replay reads.  A leaf of another shape or dtype, or a differing
    non-tensor leaf (which a graph would freeze), raises."""
    dsts, srcs = [], []
    for (path, d), (_, s) in zip(_leaves(dst), _leaves(src), strict=True):
        if torch.is_tensor(d):
            if d.shape != s.shape or d.dtype != s.dtype:
                raise GraphCaptureError(
                    f"state leaf {path} changes from {tuple(d.shape)} "
                    f"{d.dtype} to {tuple(s.shape)} {s.dtype} in a step")
            if d is not s:
                dsts.append(d)
                srcs.append(s)
        elif d is not s and d != s:
            raise GraphCaptureError(
                f"state leaf {path} is a host value that changes in a step "
                f"({d!r} to {s!r}); a graph would replay the first")
    if dsts:
        torch._foreach_copy_(dsts, srcs)


def add_metrics(sums: Dict[str, Any], metrics: Dict[str, Any]) -> None:
    """``metrics`` added into ``sums`` as new values (the first of a key
    taken as it is): eager sums, which may hold host values (ε on the
    CPU)."""
    for k, v in metrics.items():
        sums[k] = sums[k] + v if k in sums else v


def add_metrics_(sums: Dict[str, torch.Tensor], metrics: Dict[str, Any]) -> None:
    """``metrics`` added into the device sums ``sums`` in place (made as
    zeros at the first call).  A metric that is not a tensor would be
    frozen into a graph: it raises."""
    for k, v in metrics.items():
        if not torch.is_tensor(v):
            raise GraphCaptureError(
                f"metric {k!r} is a host value ({v!r}); a graph would "
                f"replay the value it saw at capture")
        if k not in sums:
            sums[k] = torch.zeros_like(v)
        sums[k].add_(v)


def kernel_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The kernel nodes of a captured graph made with ``keep_graph=True``
    (libcuda's ``cuGraphGetNodes`` and ``cuGraphNodeGetType``)."""
    import ctypes

    cuda = ctypes.CDLL("libcuda.so.1")
    size_p, node_p = ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_void_p)
    cuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, node_p, size_p]
    cuda.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    cuda.cuGraphGetNodes.restype = cuda.cuGraphNodeGetType.restype = ctypes.c_int
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)

    def check(rc: int, call: str) -> None:
        if rc:
            raise GraphCaptureError(f"{call} failed with CUresult {rc}")

    check(cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)), "cuGraphGetNodes")
    found = (ctypes.c_void_p * n.value)()
    check(cuda.cuGraphGetNodes(handle, found, ctypes.byref(n)), "cuGraphGetNodes")
    kind = ctypes.c_int(-1)
    kernels = 0
    for node in found[:n.value]:
        check(cuda.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        kernels += kind.value == CU_GRAPH_NODE_TYPE_KERNEL
    return kernels


@contextlib.contextmanager
def no_collection():
    """Collects the cyclic garbage, then keeps the collector from running
    until the block ends (it runs again after, if it ran before): a
    finalizer that a collection starts inside a capture, such as a dead
    graph's destructor, must not make its CUDA calls there."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class _LastOp(TorchDispatchMode):
    """Remembers the last operator dispatched (the one a capture failed
    in, when it fails)."""

    last = "no operator"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.last = str(func)
        return func(*args, **(kwargs or {}))


def _where(exc: BaseException) -> str:
    """The innermost frame of the port's own code in ``exc``'s traceback."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if "border_tpu_torch" in f.filename
              and not f.filename.endswith("graphs.py")]
    if not frames:
        return "an unknown line"
    f = frames[-1]
    return f"{f.filename.rsplit('border_tpu_torch', 1)[-1]}:{f.lineno} ({f.line})"


class LoopGraph:
    """``step(loop)`` run ``n`` times per :meth:`run`: without graphs
    (``cuda_graphs`` False) on the current stream each time; with graphs
    eagerly for its first ``WARMUP`` iterations over all calls, then
    captured once and replayed.

    ``step`` takes the loop and returns nothing: it updates tensors in
    place that keep their addresses between iterations, and adds its
    metrics with :meth:`add_metrics`.  ``generators``: every
    ``torch.Generator`` it draws from (each replay then draws anew).
    ``objects``: what the body was built for; :meth:`bound_to` tells a
    caller whether it may run this loop for other objects.  ``updates``:
    the agent updates one iteration of the body makes (kept beside the
    graph's kernel nodes in :data:`nodes`)."""

    def __init__(self, name: str, step: Callable[["LoopGraph"], None],
                 generators: Sequence[torch.Generator],
                 objects: Sequence[Any], cuda_graphs: bool, updates: int = 0):
        self.name = name
        self.updates = updates
        self.step = step
        self.generators = list(generators)
        self.objects = list(objects)
        self.cuda_graphs = cuda_graphs
        self.eager_done = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.stream: Optional[torch.cuda.Stream] = None
        self.launches_each: List[tuple] = []
        self.collectives_each: Dict[tuple, int] = {}
        # the timed edges of the update split captured with the body
        # (tracing level ``detail`` at capture time), which every replay
        # records: :mod:`border_tpu_torch.utils.profiling`
        self.edges: List[tuple] = []
        # the body's metric sums over a run, and for a prefetching body the
        # batch it carries between iterations (fixed tensors under graphs)
        self.sums: Dict[str, Any] = {}
        self.held: Any = None

    def bound_to(self, objects: Sequence[Any]) -> bool:
        return len(objects) == len(self.objects) and all(
            a is b for a, b in zip(objects, self.objects))

    def add_metrics(self, metrics: Dict[str, Any]) -> None:
        """The body's ``metrics`` added into :attr:`sums`: in place into
        device sums under graphs (:func:`add_metrics_`: a host value
        raises), else as they come (:func:`add_metrics`)."""
        (add_metrics_ if self.cuda_graphs else add_metrics)(self.sums, metrics)

    def _side_stream(self) -> torch.cuda.Stream:
        if self.stream is None:
            self.stream = torch.cuda.Stream()
        return self.stream

    def run(self, n: int) -> None:
        """``n`` iterations of the body, :attr:`sums` zeroed first."""
        if n <= 0:
            return
        if not self.cuda_graphs:
            # new sums: an eager sum may be the body's own metric tensor
            self.sums = {}
            for _ in range(n):
                self.step(self)
            return
        for v in self.sums.values():
            v.zero_()
        if self.graph is None:
            profiling.graph_ran(built=True)
            w = min(n, WARMUP - self.eager_done)
            if w > 0:
                with profiling.span("graph.warmup", tag=self.name):
                    s = self._side_stream()
                    s.wait_stream(torch.cuda.current_stream())
                    with torch.cuda.stream(s):
                        for _ in range(w):
                            self.step(self)
                    torch.cuda.current_stream().wait_stream(s)
                self.eager_done += w
                counts[self.name, "warmups"] += w
                n -= w
            if n == 0:
                return
            with profiling.span("graph.capture", tag=self.name):
                self._capture()
            counts[self.name, "captures"] += 1
        # the first replay's launch is timed: a full launch queue stalls it
        t = time.perf_counter_ns()
        self.graph.replay()
        first_ns = time.perf_counter_ns() - t
        for _ in range(n - 1):
            self.graph.replay()
        counts[self.name, "replays"] += n
        profiling.graph_ran(first_ns, self.edges)
        for fn, k in self.launches_each:
            fn.launches += k * n
        for key, k in self.collectives_each.items():
            collectives.counts[key] += k * n

    def _capture(self) -> None:
        # the captured cudaGraph_t is kept to count its nodes, and the
        # executable graph instantiated here, as capture_end would
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for gen in self.generators:
            graph.register_generator_state(gen)
        before = [fn.captured for fn in COUNTED]
        before_collectives = collectives.captured.copy()
        last = _LastOp()
        profiling.take_captured()  # what a failed capture left
        try:
            with no_collection(), torch.cuda.graph(graph, stream=self._side_stream()):
                with last:
                    self.step(self)
        except GraphCaptureError:
            raise
        except Exception as e:  # noqa: BLE001 — re-raised with the operator
            cause = e.__context__ if e.__context__ is not None else e
            msg = (str(cause).strip() or type(cause).__name__).splitlines()[0]
            if "legacy stream" in msg:
                msg += (" (an autograd graph of the parameters made on the "
                        "default stream is still alive: make such forwards "
                        "under torch.no_grad())")
            raise GraphCaptureError(
                f"capturing the {self.name} into a CUDA graph failed at "
                f"operator {last.last}, called from {_where(cause)}: {msg}"
            ) from e
        self.launches_each = [(fn, fn.captured - b)
                              for fn, b in zip(COUNTED, before)
                              if fn.captured != b]
        self.collectives_each = dict(collectives.captured - before_collectives)
        self.edges = profiling.take_captured()
        nodes.pop(self.name, None)
        nodes[self.name] = (kernel_nodes(graph), self.updates)
        graph.instantiate()
        self.graph = graph


def bound_loop(graphs: Dict[str, LoopGraph], name: str, objects: Sequence[Any],
               step: Callable[[LoopGraph], None],
               generators: Sequence[torch.Generator], cuda_graphs: bool,
               updates: int = 0) -> LoopGraph:
    """``graphs[name]`` while it is bound to ``objects``; else a new
    :class:`LoopGraph` of ``step``, kept there (an owner's loops, one a
    body, each made again only for other objects)."""
    loop = graphs.get(name)
    if loop is None or not loop.bound_to(objects):
        loop = graphs[name] = LoopGraph(name, step, generators, objects,
                                        cuda_graphs, updates)
    return loop
