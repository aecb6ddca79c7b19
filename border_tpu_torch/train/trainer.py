"""Synchronous chunked trainer (≙ border_tpu/train/trainer.py).

Each chunk runs

    K env steps   (num_envs vectorised instances: act → step → push)
    M updates     (sample from device replay → gradient step)

with ``M = K·num_envs/opt_interval · n_updates_per_opt``, the reference's
update:sample ratio.  The JAX trainer compiles a chunk into one XLA program
of two ``lax.scan``s.  Here one env step and one update are each written
once as a loop body, which a :class:`~border_tpu_torch.train.graphs.LoopGraph`
runs K and M times: on a CUDA device as replays of its captured CUDA graph;
with ``cuda_graphs=False``, and always on the CPU, as a Python loop over the
body (which on the card queues without waiting for it).  The counters (env
steps, write cursor, draw range, update count) advance on the device on the
card and as host ints on the CPU, and the chunk's metrics are summed on the
device, so a chunk costs one device→host sync, at its end: on the card it
also brings the host mirrors of the counters up to date.  Each chunk is traced
(:mod:`border_tpu_torch.utils.profiling`): the span ``chunk`` with its env
and update phases, timed on the device, and the host's ``sync_counters``
and ``metrics_to_host``.

The Python shell around the chunks handles the cadences: warmup on buffer
fill, periodic evaluation with best-model selection, model saves, record
flushing, compute-cost records and full-state checkpoints, all at chunk
granularity.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from border_tpu_torch.agents.common import param_stats
from border_tpu_torch.core.agent import Agent
from border_tpu_torch.core.env import Environment, VecEnv
from border_tpu_torch.errors import ConfigError
from border_tpu_torch.record.record import Record
from border_tpu_torch.record.recorder import NullRecorder, Recorder
from border_tpu_torch.replay.buffer import ReplayBuffer, Transition, map_obs
from border_tpu_torch.train.config import TrainerConfig
from border_tpu_torch.train.evaluator import Evaluator
from border_tpu_torch.train.graphs import (
    LoopGraph,
    bound_loop,
    copy_into,
    resolve_cuda_graphs,
)
from border_tpu_torch.utils import profiling
from border_tpu_torch.utils.counters import count, sync_counters
from border_tpu_torch.utils.device import DeviceLike, resolve_device


def _reconcile_next_cadence(stored: int, interval: int, opt_steps: int):
    """Reconcile a restored cadence counter with the CURRENT config.

    The stored value only means something while the feature stays enabled:
    interval=0 now means disabled (None) whatever the history; enabled now
    but disabled or unknown before (stored < 0) schedules the next firing
    one interval from the current position.  A stale counter never falls
    behind ``opt_steps`` (it would fire every iteration)."""
    if not interval:
        return None
    if stored < 0:
        return opt_steps + interval
    return max(stored, opt_steps - opt_steps % interval)


def _slice_batch(batch, lo: int, hi: int):
    """Rows ``[lo, hi)`` of every field of a sampled batch."""
    return type(batch)(**{
        f.name: None if getattr(batch, f.name) is None
        else map_obs(lambda x: x[lo:hi], getattr(batch, f.name))
        for f in dataclasses.fields(batch)
    })


def update_step(agent: Agent, buffer, agent_state, buf_state,
                gen: torch.Generator, batch_size: int):
    """One update of the sequential loop: sample, update, priority
    feedback.  Returns the states and the update's metrics."""
    cuda = gen.device.type == "cuda"
    with profiling.detail("update.sample", cuda):
        batch = buffer.sample(buf_state, gen, batch_size,
                              n_opts=count(agent_state, "n_opts"))
    agent_state, metrics, td_err = agent.update(agent_state, batch, gen)
    if td_err is not None:
        with profiling.detail("update.priority", cuda):
            buf_state = buffer.update_priority(buf_state, batch.ix_sample, td_err)
    return agent_state, buf_state, metrics


def sequential_updates(owner, agent_state, buf_state, gen: torch.Generator,
                       batch_size: int, m: int):
    """``m`` updates in order, each on its own sample, with priority
    feedback: the JAX trainers' sequential update loop, one update a run
    of ``owner``'s loop ``"update"`` (its ``agent``, ``buffer``,
    ``_graphs`` and ``cuda_graphs``).  Returns the states and the metrics'
    means over the burst, tensors still on the device."""
    def step(loop):
        st, bs, metrics = update_step(owner.agent, owner.buffer, agent_state,
                                      buf_state, gen, batch_size)
        _same_states(st, agent_state, bs, buf_state)
        loop.add_metrics(metrics)

    loop = bound_loop(owner._graphs, "update", (agent_state, buf_state, gen),
                      step, [gen], owner.cuda_graphs, updates=1)
    loop.run(m)
    return agent_state, buf_state, {k: v / m for k, v in loop.sums.items()}


def _same_states(agent_state, want_agent, buf_state, want_buf) -> None:
    """A loop body's states must be updated in place: a step that returns
    new state objects would leave a graph writing the old."""
    if agent_state is not want_agent or buf_state is not want_buf:
        raise ConfigError(
            "a loop body returned new state objects; the agent and the "
            "buffer must update their states in place")


def metrics_to_host(metrics: Dict[str, Any], *scalars: torch.Tensor):
    """One device→host copy for every tensor metric and the device
    ``scalars``: returns (the metrics as a Record, the scalars' values)."""
    with profiling.span("metrics_to_host"):
        keys = [k for k, v in metrics.items() if torch.is_tensor(v)]
        tensors = [*scalars, *(metrics[k].float() for k in keys)]
        vals = torch.stack(tensors).tolist() if tensors else []
        rec = Record({k: float(v) for k, v in metrics.items()
                      if not torch.is_tensor(v)})
        rec.merge_inplace(Record(dict(zip(keys, vals[len(scalars):]))))
    return rec, vals[:len(scalars)]


def param_stats_record(agent: Agent, agent_state) -> Record:
    """Per-tensor statistics of the policy's parameters, one copy to the
    host."""
    stats = param_stats(agent.policy_params(agent_state), prefix="param/")
    return Record(dict(zip(stats, torch.stack(list(stats.values())).tolist())))


def example_transition(observation_space, action_space, device) -> Transition:
    """The zero transition a flat buffer sizes its storage from (the frame
    buffer knows its shapes and ignores it)."""
    obs0 = observation_space.zero(device)
    flag = torch.zeros((), dtype=torch.bool, device=device)
    return Transition(
        obs=obs0,
        act=action_space.zero(device),
        next_obs=obs0,
        reward=torch.zeros((), device=device),
        terminated=flag,
        truncated=flag,
    )


@dataclasses.dataclass
class TrainResult:
    """Final states + throughput stats."""

    agent_state: Any
    buffer_state: Any
    env_steps: int
    opt_steps: int
    duration_sec: float
    samples_per_sec: float
    opt_per_sec: float
    best_score: float
    eval_history: List[Tuple[int, float]]


class Trainer:
    def __init__(
        self,
        env: Environment,
        agent: Agent,
        buffer,
        config: TrainerConfig = TrainerConfig(),
        recorder: Optional[Recorder] = None,
        evaluator: Optional[Evaluator] = None,
        checkpoint_manager=None,
        checkpoint_interval: int = 0,
        eval_callback=None,
        device: DeviceLike = None,
        cuda_graphs: Optional[bool] = None,
    ):
        """``cuda_graphs``: run the chunk's env steps and updates as replays
        of captured CUDA graphs.  None: on a CUDA device, not on the CPU;
        False: the eager chunk, also on the card; True on the CPU raises."""
        c = config
        self.env = env
        self.agent = agent
        self.buffer = buffer
        self.config = config
        self.recorder = recorder or NullRecorder()
        self.evaluator = evaluator
        # full-training-state snapshots every checkpoint_interval optimizer
        # steps; 0 disables
        self.checkpoint_manager = checkpoint_manager
        self.checkpoint_interval = checkpoint_interval
        # called after every evaluation with (opt_steps, env_steps, score,
        # best_score)
        self.eval_callback = eval_callback
        self.device = resolve_device(device)
        if torch.device(buffer.device) != self.device:
            raise ValueError(
                f"buffer on {buffer.device}, trainer on {self.device}"
            )
        self.vec = VecEnv(env, c.num_envs, device=self.device)
        self.cuda_graphs = resolve_cuda_graphs(
            cuda_graphs, self.device, self.graphable, type(self).__name__)
        self._graphs: Dict[str, LoopGraph] = {}

        transitions_per_chunk = c.steps_per_chunk * c.num_envs
        self.updates_per_chunk = max(
            1, round(transitions_per_chunk / c.opt_interval)
        ) * c.n_updates_per_opt
        self._check_sample_batches(buffer)
        self._check_nstep_stride(buffer, self._nstep_expected_stride())
        self._check_nstep_clip(agent, buffer)
        self._check_nstep_gamma(agent, buffer)

    # False where the chunk cannot be captured: GSPMDTrainer, whose
    # collectives run outside any graph, and ShardedTrainer over gloo (set
    # per instance from its group's backend); such a trainer runs eagerly
    graphable = True

    def _nstep_expected_stride(self) -> int:
        """The envs pushed into one buffer per vec step (ShardedTrainer:
        the rank's envs)."""
        return self.config.num_envs

    def _check_sample_batches(self, buffer) -> None:
        """``updates_per_sample_batch`` cuts one big uniform sample into
        whole sub-batches: it must divide the chunk's update count, and in
        slice mode each sub-batch must hold whole groups."""
        c = self.config
        ups = c.updates_per_sample_batch
        if ups <= 1 or buffer.per is not None:
            return
        if self.updates_per_chunk % ups:
            raise ConfigError(
                f"updates_per_sample_batch ({ups}) must divide the "
                f"chunk's update count ({self.updates_per_chunk})"
            )
        if (getattr(buffer, "sample_mode", None) == "slice"
                and c.batch_size % buffer.slice_group):
            raise ConfigError(
                f"slice_group ({buffer.slice_group}) must divide batch_size "
                f"({c.batch_size}) when updates_per_sample_batch > 1"
            )

    @staticmethod
    def _check_nstep_stride(buffer, expected: int) -> None:
        """An n-step flat buffer reads an env's next transition ``stride``
        slots on: the stride must be the envs pushed per vec step, or the
        n-step windows mix transitions of different envs."""
        if (isinstance(buffer, ReplayBuffer) and buffer.n_step > 1
                and buffer.stride != expected):
            raise ConfigError(
                f"n-step ReplayBuffer stride ({buffer.stride}) must equal "
                f"the envs pushed per vec step ({expected}) — ring "
                f"neighbors would belong to different envs otherwise"
            )

    @staticmethod
    def _check_nstep_clip(agent, buffer) -> None:
        """clip_reward clips per-transition rewards; an n-step buffer's
        sampled reward is the accumulated return, so clipping it would
        compute another target than canonical n-step DQN."""
        cfg = getattr(agent, "config", None)
        if (
            getattr(cfg, "clip_reward", None) is not None
            and getattr(buffer, "n_step", 1) > 1
        ):
            raise ConfigError(
                "clip_reward with an n-step (n>1) replay buffer would clip "
                "the accumulated n-step return, not per-step rewards; "
                "clip rewards env-side instead"
            )

    @staticmethod
    def _check_nstep_gamma(agent, buffer) -> None:
        """With n_step>1 the buffer's gamma drives both the n-step reward
        sum and ``batch.discount``: the agent's gamma must agree."""
        cfg = getattr(agent, "config", None)
        agent_gamma = getattr(cfg, "gamma", None)
        if (
            agent_gamma is not None
            and getattr(buffer, "n_step", 1) > 1
            and abs(float(getattr(buffer, "gamma", agent_gamma))
                    - float(agent_gamma)) > 1e-9
        ):
            raise ConfigError(
                f"agent gamma ({agent_gamma}) != n-step buffer gamma "
                f"({buffer.gamma}); pass the same gamma to both"
            )

    # ------------------------------------------------------------------
    # chunk
    # ------------------------------------------------------------------
    def _env_step(self, agent_state, vec_state, buf_state,
                  gen: torch.Generator, explore: bool, loop: LoopGraph):
        """One env step: act → step → push, the finished episodes' returns
        and count added into ``loop``'s sums ``ep_ret`` and ``ep_cnt``."""
        if explore:
            action = self.agent.select_action(agent_state, vec_state.obs, gen)
        else:
            action = self.agent.select_action_eval(agent_state, vec_state.obs, gen)
        prev_obs = vec_state.obs
        prev_ep_len = vec_state.episode_length
        ts, vec_state = self.vec.step(vec_state, action)
        buf_state = self.buffer.process_step(
            buf_state, prev_obs, action, ts, prev_ep_len
        )
        agent_state = self.agent.on_env_step(agent_state, self.config.num_envs)
        done_f = ts.done.float()
        loop.add_metrics({"ep_ret": (done_f * vec_state.last_return).sum()})
        loop.add_metrics({"ep_cnt": done_f.sum()})
        return agent_state, vec_state, buf_state

    def _env_scan(self, agent_state, vec_state, buf_state,
                  gen: torch.Generator, explore: bool):
        """K env steps: act → step → push, each next env state copied into
        ``vec_state``'s tensors.  Returns the same state objects and the
        device sums of the finished episodes' returns and of their count."""
        def step(loop):
            st, new_vec, bs = self._env_step(agent_state, vec_state, buf_state,
                                             gen, explore, loop)
            _same_states(st, agent_state, bs, buf_state)
            copy_into(vec_state, new_vec)

        loop = bound_loop(self._graphs,
                          f"env step ({'explore' if explore else 'greedy'})",
                          (agent_state, vec_state, buf_state, gen), step,
                          [gen, vec_state.gen], self.cuda_graphs)
        loop.run(self.config.steps_per_chunk)
        # copies: the next chunk's replays write the sums again
        ep_ret, ep_cnt = (loop.sums[k].clone() for k in ("ep_ret", "ep_cnt"))
        return agent_state, vec_state, buf_state, ep_ret, ep_cnt

    def _update_scan(self, agent_state, buf_state, gen: torch.Generator):
        """M gradient steps: sample → update → priority feedback.  Returns
        the metrics' means, tensors still on the device.

        Uniform replay has two more orders, as in the JAX trainer:
        ``updates_per_sample_batch`` = u > 1 draws one sample of ``B·u``
        and cuts it into u sub-batches, u updates a loop iteration;
        ``prefetch_sample`` starts the sample for update i+1 before update
        i (M+1 samples a chunk, the last unused): the chunk's first sample
        is drawn before the loop, and each iteration's is held in fixed
        tensors for the next.  On one CUDA stream prefetching only reorders
        the launches; it is kept so the draws come in the reference's
        order.  PER keeps the sequential order: its draw depends on the
        priorities the previous update wrote."""
        c = self.config
        B, M = c.batch_size, self.updates_per_chunk
        uniform = self.buffer.per is None
        ups = c.updates_per_sample_batch if uniform else 1
        prefetch = ups == 1 and uniform and c.prefetch_sample
        if ups == 1 and not prefetch:
            return sequential_updates(self, agent_state, buf_state, gen, B, M)

        def sample(n):
            return self.buffer.sample(buf_state, gen, n,
                                      n_opts=count(agent_state, "n_opts"))

        def update(loop, batch):
            st, metrics, _ = self.agent.update(agent_state, batch, gen)
            _same_states(st, agent_state, buf_state, buf_state)
            loop.add_metrics(metrics)

        def step(loop):
            if prefetch:
                nxt = sample(B)
                update(loop, loop.held)
                copy_into(loop.held, nxt)
            else:
                big = sample(B * ups)
                for i in range(ups):
                    update(loop, _slice_batch(big, i * B, (i + 1) * B))

        loop = bound_loop(self._graphs, "prefetched update" if prefetch
                          else "sample-batch updates",
                          (agent_state, buf_state, gen), step, [gen],
                          self.cuda_graphs, updates=ups)
        if prefetch:  # the chunk's first sample, the first update's batch
            head = sample(B)
            if loop.held is None:
                loop.held = head
            else:
                copy_into(loop.held, head)
        loop.run(M // ups)
        return agent_state, buf_state, {k: v / M for k, v in loop.sums.items()}

    def _chunk(self, agent_state, vec_state, buf_state, gen: torch.Generator,
               do_update: bool, do_env: bool = True):
        """The chunk's env phase and update phase, each a span timed on
        the device by events at its edges (:mod:`border_tpu_torch.utils.profiling`)."""
        cuda = self.device.type == "cuda"
        with profiling.chunk(self.config.steps_per_chunk if do_env else 0,
                             self.vec.num_envs,
                             self.updates_per_chunk if do_update else 0):
            if do_env:
                with profiling.span("chunk.env", cuda=cuda):
                    agent_state, vec_state, buf_state, ep_ret, ep_cnt = (
                        self._env_scan(agent_state, vec_state, buf_state, gen,
                                       explore=True))
            else:
                ep_ret = ep_cnt = torch.zeros((), device=self.device)
            metrics = {}
            if do_update:
                with profiling.span("chunk.update", cuda=cuda):
                    agent_state, buf_state, metrics = self._update_scan(
                        agent_state, buf_state, gen
                    )
            if self.cuda_graphs:  # the host mirrors of the replayed counters
                with profiling.span("chunk.sync_counters"):
                    sync_counters(agent_state, buf_state)
        return agent_state, vec_state, buf_state, metrics, ep_ret, ep_cnt

    def _dispatch(self, agent_state, vec_state, buffer_state,
                  gen: torch.Generator, warmed: bool):
        """One loop iteration's device work: here the chunk, acting and
        learning with the same parameters.  ``AsyncTrainer`` overrides it
        with an actor phase on stale parameters and a learner phase, and
        inherits every cadence of :meth:`train`."""
        return self._chunk(agent_state, vec_state, buffer_state, gen, warmed)

    # subclass checkpoint hooks: state beyond the agent's, the buffer's and
    # the loop's that a resumed run needs to go on bit-exactly
    def _checkpoint_extra(self, agent_state) -> dict:
        return {}

    def _restore_checkpoint_extra(self, ex: dict, agent_state) -> None:
        """``ex``: the restored ``extra``; a module saved by
        :meth:`_checkpoint_extra` comes back as its ``state_dict``."""

    # subclass hooks of the loop (ShardedTrainer: per rank, over the group)
    def _loop_generator(self, seed: int) -> torch.Generator:
        """The generator of the loop's action and replay draws."""
        return torch.Generator(device=self.device).manual_seed(seed + 2)

    def _buffer_fill(self, buffer_state) -> int:
        """The sampleable transitions the warmup compares."""
        return self.buffer.fill(buffer_state)

    def _evaluate(self, agent_state, eval_index: int):
        """``(score, record)`` of one evaluation."""
        return self.evaluator.evaluate(self.agent, agent_state,
                                       eval_index=eval_index)

    # ------------------------------------------------------------------
    # state construction
    # ------------------------------------------------------------------
    def init_states(self, seed_agent, seed_env):
        with profiling.span("trainer.init_states"):
            with profiling.span("agent.init"):
                agent_state = self.agent.init(
                    seed_agent, self.vec.observation_space,
                    self.vec.action_space, device=self.device,
                )
            with profiling.span("env.reset"):
                vec_state = self.vec.reset(seed_env)
            with profiling.span("buffer.init"):
                buffer_state = self.buffer.init(example_transition(
                    self.vec.observation_space, self.vec.action_space,
                    self.device))
        return agent_state, vec_state, buffer_state

    # ------------------------------------------------------------------
    # orchestration shell (≙ Trainer::train, trainer.rs:267-327)
    # ------------------------------------------------------------------
    def train(
        self,
        seed: Optional[int] = None,
        agent_state: Optional[Any] = None,
        buffer_state: Optional[Any] = None,
        resume_from: Optional[Any] = None,
    ) -> TrainResult:
        """Run the training loop.  ``seed`` (default ``config.seed``) seeds
        the agent's initial parameters, the envs, and the loop's action and
        replay draws, each from its own generator.

        ``resume_from``: a :class:`border_tpu_torch.utils.CheckpointManager`
        whose latest full-state checkpoint (agent, buffer and env states,
        both generators, loop counters) is restored before the loop starts:
        the resumed run continues bit-exactly where the checkpointed run
        stood.  ``eval_history`` covers only the evaluations after the
        resume; their seed indices go on from the saved count (the JAX
        trainer restarts them at 0, so its resumed run evaluates on other
        resets than its uninterrupted one).
        """
        c = self.config
        seed = c.seed if seed is None else seed
        self._graphs = {}  # graphs of an earlier call hold other states
        init_agent, vec_state, init_buffer = self.init_states(seed, seed + 1)
        if agent_state is None:
            agent_state = init_agent
        if buffer_state is None:
            buffer_state = init_buffer
        gen = self._loop_generator(seed)

        env_steps = opt_steps = 0
        best_score = -float("inf")
        eval_history: List[Tuple[int, float]] = []
        # evaluations made since step 0, before a resume too: the index
        # that seeds each evaluation's resets and actions
        n_evals = 0
        next_eval = c.eval_interval
        next_save = c.save_interval if c.save_interval else None
        next_flush = c.flush_record_interval
        next_cost = c.record_compute_cost_interval
        next_ckpt = self.checkpoint_interval
        next_agent_info = 0

        if resume_from is not None:
            restored = resume_from.restore(
                agent_state, buffer_state, vec_state, key=gen
            )
            agent_state = restored["agent_state"]
            buffer_state = restored["buffer_state"]
            vec_state = restored["vec_state"]
            ex = restored["extra"]
            env_steps = int(ex["env_steps"])
            opt_steps = int(ex["opt_steps"])
            best_score = float(ex["best_score"])
            n_evals = int(ex["n_evals"])
            next_eval = int(ex["next_eval"])
            next_save = _reconcile_next_cadence(
                int(ex["next_save"]), c.save_interval, opt_steps
            )
            next_flush = int(ex["next_flush"])
            next_ckpt = int(ex["next_ckpt"])
            next_agent_info = int(ex["next_agent_info"])
            next_cost = int(ex["next_cost"])
            self._restore_checkpoint_extra(ex, agent_state)

        # the rates cover only this call's work: the counters may start
        # non-zero after a resume
        start_env_steps, start_opt_steps = env_steps, opt_steps
        cost_time, cost_updates, cost_transitions = 0.0, 0, 0
        transitions_per_chunk = c.steps_per_chunk * c.num_envs
        t0 = time.perf_counter()

        while opt_steps < c.max_opts:
            warmed = self._buffer_fill(buffer_state) >= max(
                c.warmup_period, c.batch_size
            )
            t_chunk = time.perf_counter()
            agent_state, vec_state, buffer_state, metrics, ep_ret, ep_cnt = (
                self._dispatch(agent_state, vec_state, buffer_state, gen, warmed)
            )
            # the chunk's one device→host sync: every device scalar at once
            rec, (ret_sum, ret_cnt) = metrics_to_host(metrics, ep_ret, ep_cnt)
            dt = time.perf_counter() - t_chunk

            env_steps += transitions_per_chunk
            if warmed:
                opt_steps = agent_state.n_opts

            # -- telemetry (≙ trainer.rs:305-320 record/store/flush) -------
            if ret_cnt > 0:
                rec["episode_return_train"] = ret_sum / ret_cnt
            rec["env_steps"] = float(env_steps)
            rec["samples_per_sec"] = transitions_per_chunk / dt
            if warmed:
                rec["opt_steps_per_sec"] = self.updates_per_chunk / dt
            self.recorder.store(rec)

            # -- compute-cost records every record_compute_cost_interval ---
            cost_time += dt
            cost_transitions += transitions_per_chunk
            if warmed:
                cost_updates += self.updates_per_chunk
            if c.record_compute_cost_interval and opt_steps >= next_cost:
                cost = Record({
                    "average_sample_time": 1e3 * cost_time / max(cost_transitions, 1)
                })
                if cost_updates:
                    cost["average_opt_time"] = 1e3 * cost_time / cost_updates
                self.recorder.write_at(cost, opt_steps)
                cost_time, cost_updates, cost_transitions = 0.0, 0, 0
                next_cost += c.record_compute_cost_interval

            if opt_steps >= next_flush:
                self.recorder.flush(opt_steps)
                next_flush += c.flush_record_interval

            # -- periodic per-tensor param stats ---------------------------
            if (c.record_agent_info_interval and warmed
                    and opt_steps >= next_agent_info):
                self.recorder.write_at(
                    param_stats_record(self.agent, agent_state), opt_steps)
                next_agent_info = opt_steps + c.record_agent_info_interval

            # -- evaluation + best-model (≙ post_process, trainer.rs:231-264)
            if self.evaluator is not None and opt_steps >= next_eval:
                score, eval_rec = self._evaluate(agent_state, n_evals)
                n_evals += 1
                eval_history.append((opt_steps, score))
                self.recorder.write_at(eval_rec, opt_steps)
                if score > best_score:
                    best_score = score
                    if self.recorder.model_dir is not None:
                        self.recorder.save_model("best", self.agent, agent_state)
                if self.eval_callback is not None:
                    self.eval_callback(opt_steps, env_steps, score, best_score)
                next_eval += c.eval_interval

            if next_save is not None and opt_steps >= next_save:
                if self.recorder.model_dir is not None:
                    self.recorder.save_model(str(opt_steps), self.agent, agent_state)
                # advance PAST the current opt count: a chunk crossing
                # several cadence points saves once and never falls behind
                next_save = opt_steps + c.save_interval

            if (self.checkpoint_manager is not None
                    and self.checkpoint_interval and opt_steps >= next_ckpt):
                next_ckpt = opt_steps + self.checkpoint_interval
                self.checkpoint_manager.save(
                    opt_steps, agent_state, buffer_state, vec_state, key=gen,
                    extra={
                        "env_steps": env_steps,
                        "opt_steps": opt_steps,
                        "best_score": best_score,
                        "n_evals": n_evals,
                        "next_eval": next_eval,
                        "next_save": -1 if next_save is None else next_save,
                        "next_flush": next_flush,
                        "next_ckpt": next_ckpt,
                        "next_agent_info": next_agent_info,
                        "next_cost": next_cost,
                        **self._checkpoint_extra(agent_state),
                    },
                )

        duration = time.perf_counter() - t0
        self.recorder.flush(opt_steps)
        return TrainResult(
            agent_state=agent_state,
            buffer_state=buffer_state,
            env_steps=env_steps,
            opt_steps=opt_steps,
            duration_sec=duration,
            samples_per_sec=(env_steps - start_env_steps) / duration,
            opt_per_sec=(opt_steps - start_opt_steps) / duration,
            best_score=best_score,
            eval_history=eval_history,
        )
