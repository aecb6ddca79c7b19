"""Decoupled actor-learner over the ranks of a process group
(≙ border_tpu/parallel/async_sharded.py).

Combines :class:`border_tpu_torch.train.AsyncTrainer`'s stale-parameter,
periodic-sync shell with :class:`ShardedTrainer`'s per-rank chunk: the
actor fleet is the env shards of every rank.
"""

from __future__ import annotations

from border_tpu_torch.parallel.sharded import ShardedTrainer
from border_tpu_torch.train.async_trainer import AsyncTrainer


class ShardedAsyncTrainer(AsyncTrainer, ShardedTrainer):
    """MRO: AsyncTrainer's ``_dispatch`` over ShardedTrainer's chunk;
    ``graphable`` is ShardedTrainer's, set per instance from the group's
    backend (graphs under NCCL, eager under gloo)."""
