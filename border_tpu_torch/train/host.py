"""Host env → device learner training loop (≙ border_tpu/train/host.py).

The host side is any vectorised host env with the ``NativeVecEnv``
interface: the C++ env pool (:mod:`border_tpu_torch.envs.native`), external
Gymnasium-API envs (:class:`~border_tpu_torch.envs.py_env.PyVecEnv`) or the
real-ALE seam, stepped by an :class:`AsyncEnvFeeder` thread.  The device
side is the agent's act and update calls and the replay buffer's push, as
in the chunked :class:`~border_tpu_torch.train.Trainer`.

One iteration, pipelined one step deep:

1. the update burst for the transitions pushed so far is queued on the
   device while the feeder thread steps the host envs with the actions of
   the previous iteration;
2. the step's results are collected, uploaded and pushed into the replay,
   and the device obs advanced (in place: the push reads it first);
3. the next actions are selected and copied to the host with the counters
   (the iteration's one device→host sync, which in stream order also waits
   for the burst) and handed to the feeder.

The C++ env step overlaps the burst because a ``ctypes`` call releases the
interpreter lock; a Python env (``PyVecEnv``) holds it and contends with
the main thread's dispatch.  ``host_wait_frac`` (the share of wall time
spent waiting for env results) is recorded at chunk cadence beside
``samples_per_sec`` and ``env_steps``, from the span ``host.collect_wait``
(:mod:`border_tpu_torch.utils.profiling`), which is timed at every
tracing level.

Frame mode (uint8 stacked-frame obs and a ``FrameReplayBuffer``): only the
newest 84×84 frame crosses host→device each step; the device keeps its own
stack ring, rolled or reset to the new frame repeated on ``term | trunc``,
and the frame-dedup replay stores each frame once.  Where the host env ends
a learning episode without resetting the game (the C++ Breakout's life loss
in train mode) the device ring restarts while the host's stack goes on, as
in the JAX package, whose replay reconstructs the same restarted window.

On a CUDA device (``cuda_graphs``, as the Trainer's) an iteration's device
work is replays of captured CUDA graphs (≙ the JAX trainer's jitted
``_select``, ``_ingest``, ``_advance_stack`` and ``_update_burst``): the
burst is ``m`` replays of one captured update, and the device step (push,
the env-step counters, the stack ring and the next actions) one replay.
The host's arrays reach it through fixed tensors (:class:`HostIO`: pinned
host buffers and non-blocking copies), and the actions and the counters
come back in non-blocking copies behind one event, the iteration's one
sync, after which the host mirrors of the counters (the update count, the
ring's fill), which a replay does not advance, are set from what came
back.  ``cuda_graphs=False`` runs the same bodies eagerly.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from border_tpu_torch.core.agent import Agent
from border_tpu_torch.core.env import Timestep, index_seed
from border_tpu_torch.envs.native import AsyncEnvFeeder, NativeVecEnv
from border_tpu_torch.record.record import Record
from border_tpu_torch.record.recorder import NullRecorder, Recorder
from border_tpu_torch.replay.frame_buffer import FrameReplayBuffer
from border_tpu_torch.train.config import TrainerConfig
from border_tpu_torch.train.graphs import (
    LoopGraph,
    bound_loop,
    resolve_cuda_graphs,
)
from border_tpu_torch.train.trainer import (
    Trainer,
    TrainResult,
    _reconcile_next_cadence,
    _same_states,
    example_transition,
    metrics_to_host,
    param_stats_record,
    sequential_updates,
)
from border_tpu_torch.utils import profiling
from border_tpu_torch.utils.counters import counts_of, set_mirrors
from border_tpu_torch.utils.device import DeviceLike, as_generator, resolve_device


def _make_host_env(env: Union[str, Any], num_envs: int, seed: int,
                   n_threads: Optional[int], train: bool = True):
    """str → C++ NativeVecEnv; otherwise the env object is used as it is
    (it must expose num_envs, observation_space, action_space, reset,
    step_final, close)."""
    if isinstance(env, str):
        return NativeVecEnv(env, num_envs, seed=seed, n_threads=n_threads,
                            train=train)
    return env


class HostIO:
    """Host arrays in and device tensors out through tensors that keep
    their addresses, so a CUDA graph replay reads and writes the same
    memory every step.

    ``upload(name, x)`` copies ``x`` into the fixed device tensor ``name``
    (made at its first upload with ``x``'s shape and dtype): on a CUDA
    device through a pinned host buffer and a non-blocking copy.
    ``download(*tensors)`` brings tensors to the host: on a CUDA device in
    non-blocking copies into pinned buffers behind one event, waited for
    once.  The pinned buffers are written again only after that wait, so
    an upload's copy has left them by then.  On the CPU the fixed tensors
    are plain tensors and a download returns views of its tensors."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.dev: Dict[str, torch.Tensor] = {}
        self._pinned: Dict[Any, torch.Tensor] = {}
        self._event = torch.cuda.Event() if self.cuda else None

    def upload(self, name: str, x: np.ndarray) -> torch.Tensor:
        src = torch.as_tensor(np.ascontiguousarray(x))
        d = self.dev.get(name)
        if d is None:
            d = self.dev[name] = torch.empty(src.shape, dtype=src.dtype,
                                             device=self.device)
            if self.cuda:
                self._pinned[name] = torch.empty(src.shape, dtype=src.dtype,
                                                 pin_memory=True)
        elif d.shape != src.shape or d.dtype != src.dtype:
            raise ValueError(
                f"host array {name!r} changed from {tuple(d.shape)} {d.dtype} "
                f"to {tuple(src.shape)} {src.dtype}")
        if self.cuda:
            self._pinned[name].copy_(src)
            d.copy_(self._pinned[name], non_blocking=True)
        else:
            d.copy_(src)
        return d

    def download(self, *tensors: torch.Tensor) -> List[np.ndarray]:
        if not self.cuda:
            return [t.numpy() for t in tensors]
        out = []
        for i, t in enumerate(tensors):
            p = self._pinned.get(i)
            if p is None or p.shape != t.shape or p.dtype != t.dtype:
                p = self._pinned[i] = torch.empty(t.shape, dtype=t.dtype,
                                                  pin_memory=True)
            p.copy_(t, non_blocking=True)
            out.append(p)
        self._event.record()
        self._event.synchronize()
        return [p.numpy() for p in out]


class HostEvaluator:
    """Deterministic-seed evaluation on fresh host envs.

    ``env``: a native env name (str), built in eval mode (unclipped
    rewards), or a factory ``(n_episodes, seed) -> host env``.  The
    evaluation runs on the device of the agent's policy; the actions of
    evaluation ``i`` draw from a generator seeded by
    ``index_seed(base_seed, i + 1)``, as :class:`Evaluator`'s: one
    generator a device, re-seeded in place.  Each step's
    ``select_action_eval`` reads its observation from a fixed tensor and
    writes its actions into another, read back through a pinned buffer
    (:class:`HostIO`).  On a CUDA device (``cuda_graphs``: None or True)
    that select is a replay of one captured CUDA graph;
    ``cuda_graphs=False`` runs it eagerly, and True where the policy is on
    the CPU raises ``ConfigError``."""

    def __init__(self, env: Union[str, Callable[[int, int], Any]],
                 n_episodes: int = 5, max_steps: int = 7_000,
                 base_seed: int = 424242, cuda_graphs: Optional[bool] = None):
        # the default horizon covers the pixel envs' own episode cap
        # (27,000 emulator frames at frame-skip 4: 6,750 agent steps); an
        # evaluation capped shorter scores truncated returns, which the
        # ``Episodes truncated`` record flags
        if isinstance(env, str):
            name = env
            env = lambda n, seed: NativeVecEnv(  # noqa: E731
                name, n, seed=seed, train=False)
        # checked here against the machine, resolved at each evaluation
        # against the policy's device
        resolve_cuda_graphs(cuda_graphs, torch.device(
            "cuda" if torch.cuda.is_available() else "cpu"), owner="HostEvaluator")
        self.env_factory = env
        self.n_episodes = n_episodes
        self.max_steps = max_steps
        self.base_seed = base_seed
        self.cuda_graphs = cuda_graphs
        # on the policy's device: the fixed tensors, the action generator
        # and the loop of the select, made anew when the device changes
        self._io: Optional[HostIO] = None
        self._gen: Optional[torch.Generator] = None
        self._graphs: Dict[str, LoopGraph] = {}

    def _act(self, agent: Agent, agent_state, obs: np.ndarray,
             graphs: bool) -> np.ndarray:
        """One step's greedy actions on the host."""
        io, gen = self._io, self._gen
        obs_t = io.upload("obs", obs)

        def select(loop):
            act = agent.select_action_eval(agent_state, obs_t, gen)
            if "act" not in io.dev:
                io.dev["act"] = act
            else:
                io.dev["act"].copy_(act)

        if "act" not in io.dev:
            select(None)  # the first step makes the fixed action tensor
        else:
            bound_loop(self._graphs, "host evaluation select",
                       (agent, agent_state, agent.policy_params(agent_state)),
                       select, [gen], graphs).run(1)
        return io.download(io.dev["act"])[0]

    @torch.no_grad()
    def evaluate(self, agent: Agent, agent_state, eval_index: int = 0
                 ) -> Tuple[float, Record]:
        dev = next(agent.policy_params(agent_state).parameters()).device
        graphs = resolve_cuda_graphs(self.cuda_graphs, dev, owner="HostEvaluator")
        if self._io is None or self._io.device != dev:
            self._io, self._gen, self._graphs = HostIO(dev), None, {}
        self._gen = as_generator(index_seed(self.base_seed, eval_index + 1),
                                 dev, into=self._gen)
        env = self.env_factory(self.n_episodes, self.base_seed + eval_index)
        returns = np.zeros(self.n_episodes, np.float64)
        running = np.ones(self.n_episodes, bool)
        try:
            obs = env.reset()
            for _ in range(self.max_steps):
                act = self._act(agent, agent_state, obs, graphs)
                obs, rew, term, trunc = env.step(act)
                returns += rew * running
                running &= ~(term | trunc)
                if not running.any():
                    break
        finally:
            env.close()
        score = float(returns.mean())
        return score, Record({
            "Episode return": score,
            # horizon-capped instances are flagged, never silently dropped
            "Episodes truncated": float(running.sum()),
        })


class HostEnvTrainer:
    """Trains a device agent on host envs with host/device overlap.

    Each iteration is one lockstep vec step (``num_envs`` transitions) and
    ``num_envs / opt_interval · n_updates_per_opt`` updates, the fused
    Trainer's ratio, a fractional ratio carried as debt so the long-run
    ratio is exact.

    ``env``: a native env name (str) or a host-env object (NativeVecEnv,
    PyVecEnv, AleVecEnv, or anything with the same interface).
    ``buffer``: the flat :class:`ReplayBuffer` (any obs), or
    :class:`FrameReplayBuffer` for uint8 stacked-frame envs (frame mode).
    ``device``: where the agent and the replay live; ``None`` is the GPU.
    ``cuda_graphs``: replay the iteration's device step and update burst
    as captured CUDA graphs (None: on a CUDA device; False: eagerly; True
    on the CPU raises ``ConfigError``).
    """

    def __init__(
        self,
        env: Union[str, Any],
        agent: Agent,
        buffer: Any,
        config: TrainerConfig = TrainerConfig(),
        recorder: Optional[Recorder] = None,
        evaluator: Optional[HostEvaluator] = None,
        n_threads: Optional[int] = None,
        eval_callback=None,
        checkpoint_manager=None,
        checkpoint_interval: int = 0,
        device: DeviceLike = None,
        cuda_graphs: Optional[bool] = None,
    ):
        c = config
        self.device = resolve_device(device)
        self.cuda_graphs = resolve_cuda_graphs(cuda_graphs, self.device,
                                               owner="HostEnvTrainer")
        self._graphs: Dict[str, LoopGraph] = {}
        if torch.device(buffer.device) != self.device:
            raise ValueError(f"buffer on {buffer.device}, trainer on {self.device}")
        Trainer._check_nstep_stride(buffer, c.num_envs)
        Trainer._check_nstep_clip(agent, buffer)
        self.agent = agent
        self.buffer = buffer
        self.config = config
        self.recorder = recorder or NullRecorder()
        self.evaluator = evaluator
        # called after every evaluation with (opt_steps, env_steps, score,
        # best_score)
        self.eval_callback = eval_callback
        # full-state snapshots of the device side (agent, replay, the
        # loop's generator and counters).  The host envs are not
        # checkpointed: a resumed run restarts them fresh, and the replay
        # goes on where it stood
        self.checkpoint_manager = checkpoint_manager
        self.checkpoint_interval = checkpoint_interval
        self.updates_per_transition = c.n_updates_per_opt / c.opt_interval
        # frame mode: only the newest frame is uploaded; the device keeps
        # the stack ring
        self.frame_mode = isinstance(buffer, FrameReplayBuffer)
        self.env = _make_host_env(env, c.num_envs, c.seed, n_threads, train=True)
        if self.env.num_envs != c.num_envs:
            raise ValueError(
                f"host env has {self.env.num_envs} envs; config.num_envs is "
                f"{c.num_envs}"
            )
        self.observation_space = self.env.observation_space
        self.action_space = self.env.action_space
        if self.frame_mode and len(self.observation_space.shape) != 3:
            raise ValueError("FrameReplayBuffer needs [H, W, stack] uint8 host obs")

    # -- the device side of an iteration --------------------------------------
    def _select(self, agent_state, obs: torch.Tensor, gen: torch.Generator):
        return self.agent.select_action(agent_state, obs, gen)

    def _stage(self, io: HostIO, step, prev_ep_len: np.ndarray) -> None:
        """Upload one host step's results ``(obs, final_obs, reward,
        terminated, truncated)`` and the episode lengths before it into the
        fixed tensors :meth:`_device_step` reads.  In frame mode only the
        newest frame crosses to the device."""
        obs2, final_obs, rew, term, trunc = step
        if self.frame_mode:
            io.upload("frame", obs2[..., -1])
        else:
            io.upload("next_obs", obs2)
            io.upload("final_obs", final_obs)
        io.upload("reward", rew)
        io.upload("terminated", term)
        io.upload("truncated", trunc)
        io.upload("prev_ep_len", prev_ep_len)

    def _device_step(self, agent_state, buf_state, io: HostIO,
                     act: torch.Tensor, gen: torch.Generator):
        """Push the transition that ``act`` made from the device obs
        ``io.dev["obs"]`` through the buffer's own step processor, advance
        the agent's env-step counters, advance the device obs in place (in
        frame mode the stack ring takes the newest frame; otherwise the
        uploaded obs is copied in) and write the next actions into ``act``.
        The push reads ``act`` and the obs before either is overwritten.
        Returns the states."""
        d = io.dev
        term, trunc = d["terminated"], d["truncated"]
        ts = Timestep(obs=None, final_obs=None if self.frame_mode else d["final_obs"],
                      reward=d["reward"], terminated=term, truncated=trunc,
                      info={})
        buf_state = self.buffer.process_step(buf_state, d["obs"], act, ts,
                                             d["prev_ep_len"])
        agent_state = self.agent.on_env_step(agent_state, self.config.num_envs)
        if self.frame_mode:
            d["obs"].copy_(self._advance_stack(d["obs"], d["frame"], term | trunc))
        else:
            d["obs"].copy_(d["next_obs"])
        act.copy_(self._select(agent_state, d["obs"], gen))
        return agent_state, buf_state

    def _device_step_run(self, agent_state, buf_state, io: HostIO,
                         act: torch.Tensor, gen: torch.Generator) -> None:
        """:meth:`_device_step` once, by its loop: a replay of its capture
        on the card."""
        def step(loop):
            st, bs = self._device_step(agent_state, buf_state, io, act, gen)
            _same_states(st, agent_state, bs, buf_state)

        bound_loop(self._graphs, "device step",
                   (agent_state, buf_state, gen, io, act), step, [gen],
                   self.cuda_graphs).run(1)

    @staticmethod
    def _advance_stack(stack: torch.Tensor, frame: torch.Tensor,
                       done: torch.Tensor) -> torch.Tensor:
        """The device stack ring: roll the newest frame in, or restart the
        stack as the new frame repeated where the episode ended."""
        rolled = torch.cat([stack[..., 1:], frame[..., None]], dim=-1)
        reset = frame[..., None].expand_as(stack)
        return torch.where(done[:, None, None, None], reset, rolled)

    def _update_burst(self, agent_state, buf_state, gen: torch.Generator, m: int):
        """``m`` updates (:func:`sequential_updates`: replays of one
        captured update on the card).  Returns the states and the metrics'
        means on the device."""
        return sequential_updates(self, agent_state, buf_state, gen,
                                  self.config.batch_size, m)

    # -- orchestration ----------------------------------------------------------
    def train(self, seed: Optional[int] = None, resume_from=None) -> TrainResult:
        """Run the loop.  ``seed`` (default ``config.seed``) seeds the
        agent's initial parameters and the loop's generator (the host envs
        were seeded with ``config.seed`` when the trainer was built).

        ``resume_from``: a CheckpointManager whose latest snapshot restores
        the device side (agent, replay, the loop's generator, the counters
        and the count of evaluations, which seeds the next one); the host
        envs restart fresh.  ``eval_history`` covers only this call's
        evaluations."""
        c = self.config
        dev = self.device
        seed = c.seed if seed is None else seed
        agent_state = self.agent.init(seed, self.observation_space,
                                      self.action_space, device=dev)
        buf_state = self.buffer.init(example_transition(
            self.observation_space, self.action_space, dev))
        gen = torch.Generator(device=dev).manual_seed(seed + 2)

        env_steps = opt_steps = n_evals = 0
        best_score = -float("inf")
        eval_history: List[Tuple[int, float]] = []
        next_eval = c.eval_interval
        next_flush = c.flush_record_interval
        update_debt = 0.0
        next_ckpt = self.checkpoint_interval
        next_save = c.save_interval if c.save_interval else None
        next_agent_info = 0

        if resume_from is not None:
            restored = resume_from.restore(agent_state, buf_state, key=gen)
            agent_state = restored["agent_state"]
            buf_state = restored["buffer_state"]
            ex = restored["extra"]
            env_steps = int(ex["env_steps"])
            opt_steps = int(ex["opt_steps"])
            best_score = float(ex["best_score"])
            n_evals = int(ex["n_evals"])
            next_eval = int(ex["next_eval"])
            next_flush = int(ex["next_flush"])
            next_ckpt = int(ex["next_ckpt"])
            update_debt = float(ex["update_debt"])
            next_save = _reconcile_next_cadence(
                int(ex["next_save"]), c.save_interval, opt_steps)
            next_agent_info = int(ex["next_agent_info"])

        start_env_steps, start_opt_steps = env_steps, opt_steps
        self._graphs = {}  # graphs of an earlier call hold other states
        io = HostIO(dev)
        feeder = AsyncEnvFeeder(self.env, step_fn=self.env.step_final)
        t0 = time.perf_counter()
        try:
            # the device copy of the current obs, io.dev["obs"]; in frame
            # mode the device stack ring, which only new frames update
            # from here on
            io.upload("obs", self.env.reset())
            ep_len = np.zeros(c.num_envs, np.int32)  # steps into each episode
            wait_ns = 0
            t_window = t0
            window_steps = 0

            # prime the pipeline: the first actions go out before the loop;
            # ``act`` is the fixed tensor every device step writes
            act = self._select(agent_state, io.dev["obs"], gen)
            feeder.submit(io.download(act)[0])
            pending_ep_len = ep_len

            while opt_steps < c.max_opts:
                # the update burst, queued while the host steps the envs
                warmed = self.buffer.fill(buf_state) >= max(
                    c.warmup_period, c.batch_size)
                metrics: Dict[str, Any] = {}
                if warmed:
                    update_debt += c.num_envs * self.updates_per_transition
                    m = int(update_debt)
                    update_debt -= m
                    if m > 0:
                        agent_state, buf_state, metrics = self._update_burst(
                            agent_state, buf_state, gen, m)

                # collect the host step started last iteration
                with profiling.span("host.collect_wait", timed=True) as waited:
                    step = feeder.collect()
                wait_ns += waited.ns

                # push (obs_t, act_t, …), advance the device obs, select
                self._stage(io, step, pending_ep_len)
                self._device_step_run(agent_state, buf_state, io, act, gen)
                env_steps += c.num_envs
                window_steps += c.num_envs
                ep_len = np.where(step[3] | step[4], 0, ep_len + 1).astype(np.int32)

                # the next actions and the counters → host (the iteration's
                # one sync); the host mirrors of the counters follow them
                held = counts_of(agent_state, buf_state)
                if held is None:
                    a_np = io.download(act)[0]
                else:
                    a_np, values = io.download(act, held)
                    set_mirrors((agent_state, buf_state), values)
                feeder.submit(a_np)
                pending_ep_len = ep_len
                if warmed:
                    opt_steps = agent_state.n_opts

                # telemetry at chunk cadence
                if window_steps >= c.steps_per_chunk * c.num_envs:
                    now = time.perf_counter()
                    rec, _ = metrics_to_host(metrics)
                    rec["env_steps"] = float(env_steps)
                    rec["samples_per_sec"] = window_steps / (now - t_window)
                    rec["host_wait_frac"] = wait_ns / 1e9 / (now - t_window)
                    self.recorder.store(rec)
                    t_window, window_steps, wait_ns = now, 0, 0

                if opt_steps >= next_flush:
                    self.recorder.flush(opt_steps)
                    next_flush += c.flush_record_interval

                if (c.record_agent_info_interval and warmed
                        and opt_steps >= next_agent_info):
                    self.recorder.write_at(
                        param_stats_record(self.agent, agent_state), opt_steps)
                    next_agent_info = opt_steps + c.record_agent_info_interval

                # periodic model saves; the counter advances past the
                # current count, so a burst crossing several points saves once
                if next_save is not None and opt_steps >= next_save:
                    if self.recorder.model_dir is not None:
                        self.recorder.save_model(str(opt_steps), self.agent,
                                                 agent_state)
                    next_save = opt_steps + c.save_interval

                if (self.checkpoint_manager is not None
                        and self.checkpoint_interval and opt_steps >= next_ckpt):
                    next_ckpt = opt_steps + self.checkpoint_interval
                    self.checkpoint_manager.save(
                        opt_steps, agent_state, buf_state, key=gen,
                        extra={
                            "env_steps": env_steps,
                            "opt_steps": opt_steps,
                            "best_score": best_score,
                            "n_evals": n_evals,
                            "next_eval": next_eval,
                            "next_flush": next_flush,
                            "next_ckpt": next_ckpt,
                            "update_debt": update_debt,
                            "next_save": -1 if next_save is None else next_save,
                            "next_agent_info": next_agent_info,
                        },
                    )

                if self.evaluator is not None and opt_steps >= next_eval:
                    score, eval_rec = self.evaluator.evaluate(
                        self.agent, agent_state, eval_index=n_evals)
                    n_evals += 1
                    eval_history.append((opt_steps, score))
                    self.recorder.write_at(eval_rec, opt_steps)
                    if score > best_score:
                        best_score = score
                        if self.recorder.model_dir is not None:
                            self.recorder.save_model("best", self.agent,
                                                     agent_state)
                    if self.eval_callback is not None:
                        self.eval_callback(opt_steps, env_steps, score,
                                           best_score)
                    next_eval += c.eval_interval
        finally:
            feeder.close()

        duration = time.perf_counter() - t0
        self.recorder.flush(opt_steps)
        return TrainResult(
            agent_state=agent_state,
            buffer_state=buf_state,
            env_steps=env_steps,
            opt_steps=opt_steps,
            duration_sec=duration,
            samples_per_sec=(env_steps - start_env_steps) / duration,
            opt_per_sec=(opt_steps - start_opt_steps) / duration,
            best_score=best_score,
            eval_history=eval_history,
        )
