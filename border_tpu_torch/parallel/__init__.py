"""Multi-GPU scale-out on ``torch.distributed`` (≙ border_tpu/parallel).

One process per GPU (a rank), joined by :func:`init_distributed`:

- :class:`ShardedTrainer` — env shards and replay shards per rank, the
  learner's gradients averaged over the ``actors`` group; parameters stay
  replicated (the synchronous mode);
- :class:`ShardedAsyncTrainer` — the same with AsyncTrainer's stale actor
  parameters and periodic sync;
- :class:`GSPMDTrainer` — data parallel over ``actors`` and column-parallel
  weights over ``model`` on a dp×tp mesh (:func:`make_dp_tp_mesh`).

Importing this package starts neither CUDA nor a process group.
"""

from border_tpu_torch.parallel.distributed import (  # noqa: F401
    init_distributed,
    process_info,
)
from border_tpu_torch.parallel.gspmd import GSPMDTrainer, make_dp_tp_mesh  # noqa: F401
from border_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from border_tpu_torch.parallel.sharded import ShardedTrainer  # noqa: F401
from border_tpu_torch.parallel.async_sharded import ShardedAsyncTrainer  # noqa: F401
