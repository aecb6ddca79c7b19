"""Sharded synchronous actor-learner over the ranks of a process group
(≙ border_tpu/parallel/sharded.py).

The JAX trainer runs its chunk as one ``shard_map`` program over an
``actors`` mesh axis.  Here each rank is a process with one device, and
the same program is written out per rank:

- each rank steps ``num_envs / n`` envs and pushes into its own replay
  shard (a frame buffer's env columns are partitioned with
  ``with_num_envs``; a flat buffer is the rank's own ring);
- each update samples ``batch_size / n`` transitions from the rank's shard,
  and the agent averages its gradients over the group (``Agent.axis_group``,
  :func:`border_tpu_torch.agents.common.maybe_pmean`) before its optimizer
  step, so the parameters stay equal on every rank;
- the finished episodes' returns and counts are summed over the group, the
  chunk's metrics averaged, and the warmup reads the fill summed over the
  shards;
- ε advances by the global ``num_envs`` per env step;
- env resets and the loop's generator are seeded per rank (the port's
  ``fold_in(key, axis_index)``), so the shards' draws differ.

Every decision that gates a collective (warmup, cadences, ``max_opts``) is
computed from values that agree on every rank, so the collectives stay in
step.  The evaluator runs on rank 0 and its score is broadcast before
best-model selection; the recorder writes on rank 0 only.  Like the JAX
class it takes no checkpoint manager.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from border_tpu_torch.core.agent import Agent
from border_tpu_torch.core.env import Environment, VecEnv, index_seed
from border_tpu_torch.parallel.mesh import make_mesh
from border_tpu_torch.record.record import Record
from border_tpu_torch.record.recorder import Recorder
from border_tpu_torch.train.config import TrainerConfig
from border_tpu_torch.train.evaluator import Evaluator
from border_tpu_torch.train.trainer import (
    Trainer,
    example_transition,
    sequential_updates,
)
from border_tpu_torch.utils import collectives
from border_tpu_torch.utils.device import DeviceLike


def state_tensors(state):
    """Every tensor of an agent state: its modules' parameters and buffers,
    and its tensor fields."""
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, nn.Module):
            yield from v.parameters()
            yield from v.buffers()
        elif torch.is_tensor(v):
            yield v


@torch.no_grad()
def broadcast_state_(state, group=None) -> None:
    """The group's rank 0's agent state on every rank, in place."""
    for t in state_tensors(state):
        collectives.broadcast_(t.data, group)


def mean_metrics(metrics: dict, group) -> dict:
    """The tensor metrics averaged over ``group``, in one all-reduce; the
    host numbers (ε) agree on every rank already."""
    keys = [k for k, v in metrics.items() if torch.is_tensor(v)]
    if not keys:
        return metrics
    means = collectives.mean_(torch.stack([metrics[k].float() for k in keys]), group)
    return {**metrics, **dict(zip(keys, means.unbind()))}


class ShardedTrainer(Trainer):
    """Trainer whose chunk runs on every rank of an ``actors`` axis.

    ``config.num_envs`` and ``config.batch_size`` are global; each rank
    owns ``num_envs / n`` envs and a replay shard of ``capacity`` (so the
    global capacity is n× the single-device config, matching per-actor
    buffers).  ``mesh``: a ``DeviceMesh`` with the axis ``axis`` (default:
    every rank of the process group on one axis).

    Over NCCL the rank's env steps and updates replay captured CUDA graphs
    as the Trainer's do, each update's gradient all-reduce captured inside
    the update's graph; the collectives that run once a chunk (the episode
    sums, the metrics' mean, the summed fill, the evaluation's broadcast)
    stay outside the graphs.  gloo collectives cannot be captured: over
    gloo the chunk runs eagerly (``graphable`` is False, and
    ``cuda_graphs=True`` raises ``ConfigError``).
    """

    def __init__(
        self,
        env: Environment,
        agent: Agent,
        buffer,
        config: TrainerConfig = TrainerConfig(),
        recorder: Optional[Recorder] = None,
        evaluator: Optional[Evaluator] = None,
        mesh=None,
        axis: str = "actors",
        device: DeviceLike = None,
        cuda_graphs: Optional[bool] = None,
    ):
        # the group resolves before Trainer.__init__, whose n-step stride
        # check reads the rank's env count (_nstep_expected_stride)
        if mesh is None:
            mesh = make_mesh((axis,))
        self.mesh = mesh
        self.axis = axis
        self.group = mesh.get_group(axis)
        self.n_dev = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        # an instance attribute, so ShardedAsyncTrainer (AsyncTrainer's
        # dispatch first in its bases) resolves it from the backend too
        self.graphable = dist.get_backend(self.group) == "nccl"
        super().__init__(env, agent, buffer, config,
                         recorder if self.rank == 0 else None, evaluator,
                         device=device, cuda_graphs=cuda_graphs)
        if config.num_envs % self.n_dev:
            raise ValueError("num_envs must divide the actor axis size")
        if config.batch_size % self.n_dev:
            raise ValueError("batch_size must divide the actor axis size")
        self.local_envs = config.num_envs // self.n_dev
        self.local_batch = config.batch_size // self.n_dev
        # the rank's envs: the chunk steps these (the spaces are the same)
        self.vec = VecEnv(env, self.local_envs, device=self.device)
        # env-column buffers (FrameReplayBuffer) shard their env axis
        if hasattr(buffer, "with_num_envs"):
            if buffer.num_envs != config.num_envs:
                raise ValueError(
                    f"buffer.num_envs ({buffer.num_envs}) must equal the "
                    f"global config.num_envs ({config.num_envs})"
                )
            self.buffer = buffer.with_num_envs(self.local_envs)
        # the learner's gradients are averaged over the actors axis
        agent.axis_group = self.group

    def _nstep_expected_stride(self) -> int:
        # each replay shard receives local_envs-wide lockstep pushes
        return self.config.num_envs // self.n_dev

    # -- state ---------------------------------------------------------------
    def init_states(self, seed_agent, seed_env):
        agent_state = self.agent.init(
            seed_agent, self.vec.observation_space, self.vec.action_space,
            device=self.device,
        )
        # the same seed draws the same parameters everywhere; the broadcast
        # makes replication hold by construction
        broadcast_state_(agent_state, self.group)
        vec_state = self.vec.reset(index_seed(seed_env, self.rank))
        buffer_state = self.buffer.init(example_transition(
            self.vec.observation_space, self.vec.action_space, self.device))
        return agent_state, vec_state, buffer_state

    def _loop_generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            index_seed(seed + 2, self.rank))

    # -- the chunk -----------------------------------------------------------
    def _update_scan(self, agent_state, buf_state, gen: torch.Generator):
        """M updates in order, each on a local batch from the rank's shard
        (the JAX trainer's ``_update_scan_local``): replays of one captured
        update, its all-reduce inside, under NCCL; eagerly otherwise."""
        return sequential_updates(self, agent_state, buf_state, gen,
                                  self.local_batch, self.updates_per_chunk)

    def _chunk(self, agent_state, vec_state, buf_state, gen: torch.Generator,
               do_update: bool, do_env: bool = True):
        agent_state, vec_state, buf_state, metrics, ep_ret, ep_cnt = (
            super()._chunk(agent_state, vec_state, buf_state, gen,
                           do_update, do_env))
        if do_env:
            ep_ret, ep_cnt = collectives.all_reduce_(
                torch.stack([ep_ret, ep_cnt]), self.group).unbind()
        if do_update:
            metrics = mean_metrics(metrics, self.group)
        return agent_state, vec_state, buf_state, metrics, ep_ret, ep_cnt

    # -- the shell -----------------------------------------------------------
    def _buffer_fill(self, buffer_state) -> int:
        """The warmup reads the fill summed over the shards."""
        fill = torch.tensor([self.buffer.fill(buffer_state)],
                            dtype=torch.int64, device=self.device)
        return int(collectives.all_reduce_(fill, self.group).item())

    def _evaluate(self, agent_state, eval_index: int):
        """Rank 0 evaluates (the parameters are replicated); every rank
        gets its score."""
        score, rec = 0.0, Record()
        if self.rank == 0:
            score, rec = super()._evaluate(agent_state, eval_index)
        t = torch.tensor([score], dtype=torch.float64, device=self.device)
        return float(collectives.broadcast_(t, self.group).item()), rec
