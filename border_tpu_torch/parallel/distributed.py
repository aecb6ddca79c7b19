"""Joining the processes of a multi-GPU run (≙ border_tpu/parallel/
distributed.py).

The JAX package runs one process per host, and each process drives every
device of its host; ``jax.distributed.initialize`` joins the processes.
PyTorch runs one process per GPU (a rank) and joins them in a process
group: :func:`init_distributed` makes that group.  The sharded trainers'
collectives (the gradient mean, the episode sums, the fill) then ride
NCCL between GPUs, or gloo between CPU processes.

NCCL puts one rank on each GPU (a communicator refuses two ranks on one
device): two ranks on one card must ask for ``gloo``, which reduces CUDA
tensors through the host, with ``backend="gloo"`` or, for a program
started by a launcher, ``BORDER_TPU_DIST_BACKEND=gloo``.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

from border_tpu_torch.utils.device import DeviceLike, resolve_device


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: DeviceLike = None,
) -> None:
    """Join this process to the run's process group.

    - With no address and a launcher's environment (``RANK``,
      ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, as ``torchrun``
      sets them): the launcher's topology, as ``jax.distributed.initialize()``
      reads a pod's.
    - With no address and no launcher: a world of one rank.
    - Otherwise ``coordinator_address`` (``"host:port"``, or any
      ``init_method`` URL such as ``file:///path``), ``num_processes`` and
      this process's ``process_id``.

    ``backend``: ``$BORDER_TPU_DIST_BACKEND`` when set, else ``nccl`` when
    ``device`` is CUDA (the default device) and ``gloo`` on the CPU; a
    caller that puts several ranks on one card asks for ``gloo``.  On CUDA the rank's card is ``LOCAL_RANK`` (or the rank)
    modulo the visible cards.  Must run before the first collective.
    """
    dev = resolve_device(device)
    if backend is None:
        backend = os.environ.get("BORDER_TPU_DIST_BACKEND") or (
            "nccl" if dev.type == "cuda" else "gloo")
    if coordinator_address is None and "RANK" in os.environ:
        init_method, rank, world = "env://", None, None
    elif coordinator_address is None:
        fd, path = tempfile.mkstemp(prefix="border_tpu_pg_")
        os.close(fd)
        os.unlink(path)  # the store creates it
        init_method, rank, world = f"file://{path}", 0, 1
    else:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        rank, world = process_id, num_processes
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank if rank is not None
                                   else os.environ.get("RANK", 0)))
        torch.cuda.set_device(local % torch.cuda.device_count())
    kw = {} if rank is None else {"rank": rank, "world_size": world}
    dist.init_process_group(backend, init_method=init_method, **kw)


def process_info() -> dict:
    """Topology snapshot for logs and records, with the JAX keys.  One
    process drives one device here, so ``local_device_count`` is 1 and
    ``global_device_count`` is the world size."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": world,
        "local_device_count": 1,
        "global_device_count": world,
    }
