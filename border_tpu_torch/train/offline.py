"""Offline training from a filled replay buffer, no env
(≙ border_tpu/train/offline.py).

≙ Trainer::train_offline (border-core/src/trainer.rs:330-384): the online
loop's cadences with every iteration a gradient step on a batch drawn from
the buffer.  A chunk is ``updates_per_chunk`` updates, each a sample, an
update and, when the agent returns TD errors, a priority update; the
chunk's metrics are averaged on the device and read in its one
device→host sync.  The chunk is the Trainer's sequential update loop
(:func:`~border_tpu_torch.train.trainer.sequential_updates`): on a CUDA
device replays of one captured update, with ``cuda_graphs=False`` the
same body run eagerly.  Between chunks: record
flushes, evaluation with best-model saves, ``eval_callback``.
"""

from __future__ import annotations

import time
from typing import Any, List, Optional, Tuple

import torch

from border_tpu_torch.core.agent import Agent
from border_tpu_torch.record.record import Record
from border_tpu_torch.record.recorder import NullRecorder, Recorder
from border_tpu_torch.replay.buffer import ReplayBuffer
from border_tpu_torch.train.config import TrainerConfig
from border_tpu_torch.train.evaluator import Evaluator
from border_tpu_torch.train.trainer import (
    TrainResult,
    resolve_cuda_graphs,
    sequential_updates,
)
from border_tpu_torch.utils.counters import sync_counters


class OfflineTrainer:
    def __init__(
        self,
        agent: Agent,
        buffer: ReplayBuffer,
        config: TrainerConfig = TrainerConfig(),
        recorder: Optional[Recorder] = None,
        evaluator: Optional[Evaluator] = None,
        updates_per_chunk: int = 100,
        eval_callback=None,
        cuda_graphs: Optional[bool] = None,
    ):
        """Runs on the buffer's device.  ``cuda_graphs`` as the Trainer's:
        None graphs the chunk on a CUDA device, False runs it eagerly, True
        on the CPU raises."""
        self.agent = agent
        self.buffer = buffer
        self.config = config
        self.recorder = recorder or NullRecorder()
        self.evaluator = evaluator
        self.updates_per_chunk = updates_per_chunk
        # called after every evaluation with (opt_steps, env_steps=0,
        # score, best_score), as Trainer.eval_callback
        self.eval_callback = eval_callback
        self.cuda_graphs = resolve_cuda_graphs(
            cuda_graphs, torch.device(buffer.device), owner="OfflineTrainer")
        self._graphs = {}

    def _chunk(self, agent_state, buf_state, gen: torch.Generator):
        """``updates_per_chunk`` updates; the metrics' means, on the
        device.  The host mirrors of the counters follow (replays do not
        advance them)."""
        agent_state, buf_state, means = sequential_updates(
            self, agent_state, buf_state, gen, self.config.batch_size,
            self.updates_per_chunk)
        sync_counters(agent_state, buf_state)
        return agent_state, buf_state, means

    def train(self, agent_state: Any, buffer_state: Any,
              seed: Optional[int] = None) -> TrainResult:
        """Update until ``config.max_opts``; ``seed`` (default
        ``config.seed``) seeds the sample and update draws."""
        c = self.config
        seed = c.seed if seed is None else seed
        gen = torch.Generator(device=self.buffer.device).manual_seed(seed)
        self._graphs = {}  # graphs of an earlier call hold other states
        opt_steps = 0
        best_score = -float("inf")
        eval_history: List[Tuple[int, float]] = []
        next_eval = c.eval_interval
        next_flush = c.flush_record_interval
        t0 = time.perf_counter()

        while opt_steps < c.max_opts:
            t_chunk = time.perf_counter()
            agent_state, buffer_state, means = self._chunk(
                agent_state, buffer_state, gen)
            # the chunk's one device→host sync: every metric at once
            keys = list(means)
            vals = torch.stack([means[k].float() for k in keys]).tolist()
            dt = time.perf_counter() - t_chunk
            opt_steps = agent_state.n_opts

            rec = Record(dict(zip(keys, vals)))
            rec["opt_steps_per_sec"] = self.updates_per_chunk / dt
            self.recorder.store(rec)
            if opt_steps >= next_flush:
                self.recorder.flush(opt_steps)
                next_flush += c.flush_record_interval

            if self.evaluator is not None and opt_steps >= next_eval:
                score, eval_rec = self.evaluator.evaluate(
                    self.agent, agent_state, eval_index=len(eval_history))
                eval_history.append((opt_steps, score))
                self.recorder.write_at(eval_rec, opt_steps)
                if score > best_score:
                    best_score = score
                    if self.recorder.model_dir is not None:
                        self.recorder.save_model("best", self.agent, agent_state)
                if self.eval_callback is not None:
                    self.eval_callback(opt_steps, 0, score, best_score)
                next_eval += c.eval_interval

        duration = time.perf_counter() - t0
        self.recorder.flush(opt_steps)
        return TrainResult(
            agent_state=agent_state,
            buffer_state=buffer_state,
            env_steps=0,
            opt_steps=opt_steps,
            duration_sec=duration,
            samples_per_sec=0.0,
            opt_per_sec=opt_steps / duration,
            best_score=best_score,
            eval_history=eval_history,
        )
