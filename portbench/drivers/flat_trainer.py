"""Adapter from the benchmark to the port's fused online trainer over the
flat transition ring (``border_tpu_torch.replay.ReplayBuffer``): vector
observations and actions, uniform draws over the whole ring.

The window drives the body of ``Trainer.train()``'s loop as it runs there:
``Trainer._dispatch`` (a chunk: K env steps and M updates, CUDA-graph
replays on the card) and then ``metrics_to_host`` (the chunk's one
device→host copy).  This file is the only place that names the trainer's
internals; where they are renamed, it is repointed.

The agent is built by ``portbench/agents/<kind>.py``, which also names its
parameters as the reference does: ``build(cfg)``, ``load(cfg, state,
w0)`` (the benchmark's weights into the online networks and their
targets), ``params(state)``, ``first_grads(state)`` (each gradient of the
first update, from its optimizer's moments), ``losses(metrics)`` and
``soft_targets(cfg, state)`` (the online tensors, their targets and τ of
the soft update every update makes).

Set-up builds the trainer and its states from the seed, loads the
benchmark's weights and runs two chunks: the first captures the env
step's graph (the ring is still too empty to sample), the second the
update's.  Between them, while the weights are still the seed's, the
program's deterministic action of the first chunk's observations is
read.  While the chunks run, the first updates are recorded for the
check (:mod:`portbench.reference.checks`): the update graph's eager
warm-up and its first replays, each read back after it ran (a replay
reads the batch and loss tensors its capture wrote), and the ring after
set-up.  Nothing is added to a captured graph.  After the window,
:meth:`Driver.target_check` watches one replayed update's soft update of
the targets.
"""

from __future__ import annotations

import contextlib
import importlib
import time
from typing import Callable, Dict, List, Optional

import torch

from portbench import seeds

# the updates judged from the seed: the update graph's eager warm-up
# (border_tpu_torch.train.graphs.WARMUP, 3) and its first three replays
JUDGED_UPDATES = 6
PARAMS_AFTER = (3, 6)  # the parameters are read after these updates
RING_FIELDS = ("obs", "act", "next_obs", "reward", "terminated", "truncated")


def opt_interval(cfg: dict, wl: dict) -> int:
    """Env steps an update: the batch over the traffic's replay ratio
    (gradient samples per transition)."""
    batch, ratio = cfg["agent"]["batch_size"], wl["replay_ratio"]
    if batch % ratio:
        raise ValueError(f"replay ratio {ratio} does not divide batch {batch}")
    return batch // ratio


def _host(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if x is None else x.detach().to("cpu", copy=True)


class Driver:
    def __init__(self, cfg: dict, wl: dict, seed: int, device: torch.device):
        from border_tpu_torch.envs import make
        from border_tpu_torch.replay import ReplayBuffer
        from border_tpu_torch.train import Trainer, TrainerConfig

        if wl.get("per"):
            raise ValueError("the flat driver judges uniform replay only")
        r = cfg["replay"]
        self.kind = importlib.import_module(f"portbench.agents.{cfg['agent']['kind']}")
        self.cfg, self.wl, self.seed, self.device = cfg, wl, seed, device
        self.agent = self.kind.build(cfg)
        self.buffer = ReplayBuffer(capacity=r["capacity"], stride=r["num_envs"],
                                   device=device)
        self.config = TrainerConfig(
            num_envs=r["num_envs"], steps_per_chunk=r["steps_per_chunk"],
            batch_size=cfg["agent"]["batch_size"], opt_interval=opt_interval(cfg, wl),
            warmup_period=0, max_opts=2**62)
        self.trainer = Trainer(make(cfg["env"]), self.agent, self.buffer,
                               self.config, device=device)
        self.updates_per_chunk = self.trainer.updates_per_chunk
        self.env_steps_per_chunk = r["steps_per_chunk"] * r["num_envs"]
        self.states = None
        self.gen = None
        self.update_graph = None  # the captured update, once set-up made it
        self.setup_parts: Dict[str, float] = {}  # seconds, for the log

    # -- watching updates ------------------------------------------------------
    @contextlib.contextmanager
    def watching(self, before: Callable, after: Callable):
        """``before(gen)`` and ``after(batch, losses, agent_state)`` around
        every update the program makes in the block: an eager one through
        ``agent.update`` (``gen``: its generator), a replayed one around the
        replay of the graph that captured an update (``gen`` None;
        ``batch`` and ``losses``: the tensors the capture wrote).  A replay
        is one update: a capture that holds more raises."""
        real = self.agent.update
        losses = self.kind.losses
        captured: list = []

        def update(state, batch, gen=None, **kw):
            if batch.reward.is_cuda and torch.cuda.is_current_stream_capturing():
                out = real(state, batch, gen, **kw)
                captured.append((batch, losses(out[1])))
                return out
            before(gen)
            out = real(state, batch, gen, **kw)
            after(batch, losses(out[1]), out[0])
            return out

        def bind(graph, batch, loss):
            def replay():
                before(None)
                type(graph).replay(graph)
                after(batch, loss, self.states[0])
            graph.replay = replay  # on this instance only
            self.update_graph = graph

        cuda_graph = torch.cuda.CUDAGraph if self.device.type == "cuda" else None
        own_end = cuda_graph is not None and "capture_end" in vars(cuda_graph)
        real_end = cuda_graph.capture_end if cuda_graph is not None else None

        def capture_end(graph):
            real_end(graph)
            if captured:
                if len(captured) != 1:
                    raise RuntimeError(f"a captured graph holds {len(captured)} "
                                       f"updates; the adapter judges one a replay")
                bind(graph, *captured.pop())

        self.agent.update = update
        if cuda_graph is not None:
            cuda_graph.capture_end = capture_end
        if self.update_graph is not None:
            bind(self.update_graph, None, None)
        try:
            yield
        finally:
            del self.agent.update  # the class's method again
            if own_end:
                cuda_graph.capture_end = real_end
            elif cuda_graph is not None:
                del cuda_graph.capture_end
            if self.update_graph is not None:
                vars(self.update_graph).pop("replay", None)

    def _record(self, record: List[dict]):
        """``(before, after)`` that record the first updates for the check."""
        pending: dict = {}

        def before(gen):
            pending.clear()
            if len(record) >= JUDGED_UPDATES:
                return
            pending["gen_state"] = None if gen is None else gen.get_state()
            pending["gen_offset"] = (gen.get_offset() if gen is not None
                                     and gen.device.type == "cuda" else None)

        def after(batch, losses, state):
            if not pending:
                return
            k = len(record)
            rec = dict(pending)
            rec.update({f: _host(getattr(batch, f)) for f in RING_FIELDS[:-1]})
            rec.update(ix=_host(batch.ix_sample), losses=[float(x) for x in losses])
            if k == 0:
                rec["grad1"] = {n: _host(g) for n, g in self.kind.first_grads(state).items()}
            if k + 1 in PARAMS_AFTER:
                rec["params"] = {n: _host(p) for n, p in self.kind.params(state).items()}
            record.append(rec)

        return before, after

    # -- set-up ---------------------------------------------------------------
    def setup(self, w0: Dict[str, torch.Tensor]) -> None:
        tr = self.trainer
        t = time.perf_counter()
        self.states = tr.init_states(seeds.agent(self.seed), seeds.env(self.seed))
        self.kind.load(self.cfg, self.states[0], w0)
        self.gen = torch.Generator(device=self.device).manual_seed(seeds.loop(self.seed))
        self.setup_parts["states"] = time.perf_counter() - t
        self.record: List[dict] = []
        with self.watching(*self._record(self.record)):
            t = time.perf_counter()
            self.chunk()
            self.setup_parts["env capture chunk"] = time.perf_counter() - t
            self.greedy = self._greedy()
            t = time.perf_counter()
            self.chunk()
            self.setup_parts["update capture chunk"] = time.perf_counter() - t
        if len(self.record) < JUDGED_UPDATES:
            raise RuntimeError(f"set-up made {len(self.record)} updates, "
                               f"{JUDGED_UPDATES} are judged")

    @torch.no_grad()
    def _greedy(self) -> torch.Tensor:
        """The deterministic action of the first chunk's observations,
        before any update."""
        ag, _, buf = self.states
        obs = buf.data.obs[:self.env_steps_per_chunk]
        return _host(self.agent.select_action_eval(ag, obs))

    def observations(self) -> dict:
        """What the check reads: the first updates, the ring's rows of
        set-up's steps (copied to the host) and the deterministic actions."""
        buf = self.states[2]
        rows = 2 * self.env_steps_per_chunk
        ring = {f: _host(getattr(buf.data, f)[:rows]) for f in RING_FIELDS}
        rec = self.record
        _offsets_of_replays(rec)
        return {"ring": ring, "envs": self.config.num_envs, "updates": rec,
                "grad1": rec[0]["grad1"], "greedy": self.greedy}

    def target_check(self) -> int:
        """The next chunk's first update (a replay on the card) watched: the
        elements of the targets that differ from ``target·(1 − τ) +
        online·τ`` of the targets before it and the online tensors after."""
        seen: dict = {}

        def before(gen):
            if "held" not in seen and "off" not in seen:
                seen["held"] = [t.detach().clone()
                                for t in self.kind.soft_targets(self.cfg, self.states[0])[1]]

        def after(batch, losses, state):
            if "held" in seen:
                online, target, tau = self.kind.soft_targets(self.cfg, state)
                seen["off"] = sum(int((t != h * (1.0 - tau) + o * tau).sum())
                                  for t, h, o in zip(target, seen.pop("held"), online))

        with self.watching(before, after):
            self.chunk()
        return seen["off"]

    # -- the window's call ----------------------------------------------------
    def chunk(self) -> None:
        """One iteration of the training loop's body: the chunk, then its
        one device→host copy."""
        from border_tpu_torch.train.trainer import metrics_to_host

        tr = self.trainer
        ag, vec, buf = self.states
        warmed = tr._buffer_fill(buf) >= max(self.config.warmup_period,
                                             self.config.batch_size)
        ag, vec, buf, metrics, ep_ret, ep_cnt = tr._dispatch(ag, vec, buf,
                                                            self.gen, warmed)
        metrics_to_host(metrics, ep_ret, ep_cnt)
        self.states = (ag, vec, buf)

    # -- the phases, for device timing ----------------------------------------
    def env_phase(self) -> None:
        ag, vec, buf = self.states
        self.states = self.trainer._env_scan(ag, vec, buf, self.gen, explore=True)[:3]

    def update_phase(self) -> None:
        ag, vec, buf = self.states
        ag, buf, _ = self.trainer._update_scan(ag, buf, self.gen)
        self.states = (ag, vec, buf)

    def sync(self) -> None:
        """The host mirrors of the counters after phases run apart."""
        from border_tpu_torch.utils.counters import sync_counters

        sync_counters(self.states[0], self.states[2])

    def free(self) -> None:
        self.states = self.gen = self.trainer = self.buffer = self.agent = None
        self.update_graph = None


def _offsets_of_replays(record: List[dict]) -> None:
    """A replayed update's draws start where the eager body's next would:
    each update advances the loop generator's offset by the same amount
    (the eager updates' step, which must be steady), so a replay's offset
    at its update follows from the last eager one's.  Records with no
    generator of their own get the first eager state and that offset."""
    eager = [i for i, r in enumerate(record) if r["gen_state"] is not None]
    if len(eager) == len(record) or record[eager[0]]["gen_offset"] is None:
        return
    offs = [record[i]["gen_offset"] for i in eager]
    steps = {b - a for a, b in zip(offs, offs[1:])}
    if len(steps) != 1 or eager != list(range(len(eager))):
        raise RuntimeError(f"the eager updates {eager} advance the loop "
                           f"generator unevenly: offsets {offs}")
    step, first = steps.pop(), record[0]["gen_state"]
    for i, r in enumerate(record[len(eager):], start=len(eager)):
        r["gen_state"] = first
        r["gen_offset"] = offs[-1] + (i - eager[-1]) * step
