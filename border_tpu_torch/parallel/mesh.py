"""Device meshes over the ranks of the process group (≙ border_tpu/
parallel/mesh.py)."""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(
    axis_names: Sequence[str] = ("actors",),
    shape: Optional[Tuple[int, ...]] = None,
) -> DeviceMesh:
    """A ``DeviceMesh`` over every rank of the process group.

    Default: all ranks on one ``actors`` axis, the env- and data-parallel
    axis.  A multi-axis shape (``("actors", "model")``) lays the ranks out
    row-major, so ranks that differ in the trailing axis are neighbours,
    as the JAX mesh lays out its devices.  The mesh's device type follows
    the group's backend: ``cuda`` under NCCL, ``cpu`` under gloo (gloo
    groups reduce CUDA tensors too).
    """
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed() first")
    world = dist.get_world_size()
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("shape is required for multi-axis meshes")
        shape = (world,)
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {tuple(shape)} does not cover {world} devices")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))
