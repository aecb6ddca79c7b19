"""Adapter from the benchmark to the port's fused online trainer.

The window drives the body of ``Trainer.train()``'s loop as it runs there:
``Trainer._dispatch`` (a chunk: K env steps and M updates, CUDA-graph
replays on the card) and then ``metrics_to_host`` (the chunk's one
device→host copy).  ``train()`` itself cannot be the entry: it drops its
graphs at every call.  This file is the only place that names the
trainer's internals; where they are renamed, it is repointed.

Set-up builds the trainer, its states from the seed (the benchmark's
weights loaded into the agent's online and target networks) and runs two
chunks: the first captures the env step's graph (the ring is still too
empty to sample), the second the update's.  While those chunks run, the
first updates and the ring are recorded for the check
(:mod:`portbench.reference.check`): the updates that the graph's eager
warm-up runs and the first replays of the captured update, each read back
after it ran, and the ring after set-up.  Nothing is added to a captured
graph: a replay is watched from the host, and reads the batch and loss
tensors the capture wrote, which the graph rewrites at every replay.
After the window, :meth:`Driver.target_check` runs the window's chunks on
until the next hard copy of the target network and watches the two
updates around it.
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
        from border_tpu_torch.replay import FrameReplayBuffer, PerConfig
        from border_tpu_torch.train import Trainer, TrainerConfig

        agents = importlib.import_module(f"portbench.agents.{cfg['agent']['kind']}")
        r = cfg["replay"]
        self.cfg, self.wl, self.seed, self.device = cfg, wl, seed, device
        self.agent = agents.build(cfg)
        self.buffer = FrameReplayBuffer(
            capacity=r["capacity_per_env"], num_envs=r["num_envs"],
            stack=cfg["torso"]["stack"],
            per=PerConfig(**wl["per"]) if wl.get("per") else None, device=device)
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

    # -- set-up ---------------------------------------------------------------
    def _load(self, w0: Dict[str, torch.Tensor]) -> None:
        """The benchmark's weights into the online and target networks."""
        ag = self.states[0]
        for net in (ag.params, ag.target_params):
            named = dict(net.named_parameters())
            if set(named) != set(w0):
                raise RuntimeError(f"the program's parameters {sorted(named)} "
                                   f"are not the reference's {sorted(w0)}")
            with torch.no_grad():
                for k, p in named.items():
                    if p.shape != w0[k].shape:
                        raise RuntimeError(f"{k}: {tuple(p.shape)} in the "
                                           f"program, {tuple(w0[k].shape)} here")
                    p.copy_(w0[k])

    # -- watching updates ------------------------------------------------------
    @contextlib.contextmanager
    def watching(self, before: Callable, after: Callable):
        """``before(gen)`` and ``after(batch, loss, agent_state)`` around every
        update the program makes in the block: an eager one through
        ``agent.update`` (``gen``: its generator), a replayed one around the
        replay of the graph that captured an update (``gen`` None; ``batch``
        and ``loss``: the tensors the capture wrote, while set-up holds them).
        A replay is one update: a capture that holds more raises."""
        real = self.agent.update
        captured: list = []

        def update(state, batch, gen=None, **kw):
            if batch.obs.is_cuda and torch.cuda.is_current_stream_capturing():
                out = real(state, batch, gen, **kw)
                captured.append((batch, out[1]["loss"]))
                return out
            before(gen)
            out = real(state, batch, gen, **kw)
            after(batch, out[1]["loss"], out[0])
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
            tree = self.states[2].tree
            pending["gen_state"] = None if gen is None else gen.get_state()
            pending["gen_offset"] = (gen.get_offset() if gen is not None
                                     and gen.device.type == "cuda" else None)
            pending["tree_total"] = None if tree is None else float(tree.sum_tree[1])

        def after(batch, loss, state):
            if not pending:
                return
            k = len(record)
            rec = dict(pending)
            rec.update(obs=_host(batch.obs), next_obs=_host(batch.next_obs),
                       act=_host(batch.act), reward=_host(batch.reward),
                       terminated=_host(batch.terminated), ix=_host(batch.ix_sample),
                       weight=_host(batch.weight), loss=float(loss))
            if k == 0:
                opt = state.opt_state
                b1 = opt.param_groups[0]["betas"][0]
                # Adam's first moment after one step is (1 − β1)·g; a step
                # that left no moment reads as a zero gradient
                rec["grad1"] = {
                    n: _host(opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                             / (1 - b1))
                    for n, p in state.params.named_parameters()}
            if k + 1 in PARAMS_AFTER:
                rec["params"] = {n: _host(p) for n, p in state.params.named_parameters()}
            record.append(rec)

        return before, after

    def setup(self, w0: Dict[str, torch.Tensor]) -> None:
        tr = self.trainer
        t = time.perf_counter()
        self.states = tr.init_states(seeds.agent(self.seed), seeds.env(self.seed))
        self._load(w0)
        self.gen = torch.Generator(device=self.device).manual_seed(seeds.loop(self.seed))
        self.setup_parts["states"] = time.perf_counter() - t
        self.record: List[dict] = []
        with self.watching(*self._record(self.record)):
            for name in ("env capture chunk", "update capture chunk"):
                t = time.perf_counter()
                self.chunk()
                self.setup_parts[name] = time.perf_counter() - t
        if len(self.record) < JUDGED_UPDATES:
            raise RuntimeError(f"set-up made {len(self.record)} updates, "
                               f"{JUDGED_UPDATES} are judged")

    def observations(self) -> dict:
        """What the check reads: the first updates, and the ring's columns
        of set-up's steps (copied to the host)."""
        buf = self.states[2]
        t_steps = buf.total
        ring = {k: _host(getattr(buf, k)[:, :t_steps])
                for k in ("frames", "act", "reward", "terminated", "truncated", "age")}
        rec = self.record
        _offsets_of_replays(rec)
        return {"ring": ring, "updates": rec, "grad1": rec[0]["grad1"]}

    def target_check(self) -> int:
        """The window's chunks run on until the next hard copy of the target
        network, the update before it and the copy watched: the elements of
        the target that the update before changed, plus those that differ
        from the online network after the copy (the reference's rule: a
        copy every ``target_interval`` updates, and none between)."""
        interval = self.cfg["agent"]["target_interval"]
        if interval < 2:
            raise ValueError("target_check needs a target_interval of 2 or more")
        n = [self.states[0].n_opts]  # the host mirror, set at each chunk's end
        seen: dict = {}

        def before(gen):
            if (n[0] + 1) % interval == interval - 1:
                seen["held"] = [p.detach().clone()
                                for p in self.states[0].target_params.parameters()]

        def after(batch, loss, state):
            n[0] += 1
            tgt = list(state.target_params.parameters())
            if n[0] % interval == interval - 1 and "held" in seen:
                seen["off"] = _differ(tgt, seen.pop("held"))
            elif n[0] % interval == 0 and "off" in seen and "copy" not in seen:
                seen["copy"] = _differ(tgt, list(state.params.parameters()))

        with self.watching(before, after):
            while "copy" not in seen:
                self.chunk()
        return seen["off"] + seen["copy"]

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


def _differ(xs: List[torch.Tensor], ys: List[torch.Tensor]) -> int:
    return sum(int((x != y).sum()) for x, y in zip(xs, ys))


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
