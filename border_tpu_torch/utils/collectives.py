"""The collectives of the multi-process paths, over ``torch.distributed``
process groups (≙ the ``psum``/``pmean``/``all_gather`` that XLA inserts in
the JAX package's sharded programs).

Every collective here is an all-reduce, so one code path serves NCCL and
gloo and CUDA and CPU tensors alike:

- :func:`all_reduce_` sums in place; ``bool`` travels as ``uint8`` and
  ``bfloat16``/``float16`` as ``float32`` (gloo lacks some of these types),
  which is exact for the sums of zero-padded rows below;
- :func:`gather_rows` concatenates each rank's block along ``dim`` as a
  zero-padded all-reduce: every rank writes its block into zeros and the
  sum is the concatenation, bit for bit (``x + 0 = x``);
- :func:`gather_columns` is that gather with a backward that *slices*: the
  computation after a column-parallel layer is replicated on every rank of
  the group, so each rank's gradient of its block is the block of the
  (identical) gradient of the whole.  ``torch.distributed.nn``'s
  ``all_gather`` sums in its backward, which would scale the sharded
  gradients by the group size;
- :func:`sum_grad` is the identity whose backward sums over the group: a
  column-parallel layer's input feeds every rank's block, so its gradient
  is the sum of the blocks' contributions.

``counts[(operation, group name)]`` counts the collectives run, per group;
the tests read it to see which group an update talks to.  A call on a
stream that a CUDA graph is capturing runs nothing: it is counted in
``captured``, and each replay of the graph adds what its capture recorded
to ``counts`` (:mod:`border_tpu_torch.train.graphs`), so ``counts`` counts
one a replay.  Under capture (NCCL only: gloo collectives cannot be
captured) the sum's wire-dtype copies are captured with it.  Groups are named by
:func:`register_group`, so a tensor can carry the name of its group
(a string survives ``deepcopy`` where a process group does not).
"""

from __future__ import annotations

import collections
from typing import Dict

import torch
import torch.distributed as dist

counts: collections.Counter = collections.Counter()
captured: collections.Counter = collections.Counter()
_GROUPS: Dict[str, "dist.ProcessGroup"] = {}
# dtypes a sum travels in
_WIRE = {torch.bool: torch.uint8, torch.bfloat16: torch.float32,
         torch.float16: torch.float32}


def register_group(group, label: str) -> str:
    """A name for ``group`` under which :func:`group_by_name` finds it."""
    name = f"{label}:{group.group_name}"
    _GROUPS[name] = group
    return name


def group_by_name(name: str):
    return _GROUPS[name]


def _label(group) -> str:
    return (group or dist.group.WORLD).group_name


def _count(t: torch.Tensor, op: str, group) -> None:
    capturing = t.is_cuda and torch.cuda.is_current_stream_capturing()
    (captured if capturing else counts)[op, _label(group)] += 1


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns ``t``.  Synchronous (no
    ``async_op``), so a CUDA graph can capture it under NCCL."""
    wire = _WIRE.get(t.dtype)
    buf = t if wire is None else t.to(wire)
    dist.all_reduce(buf, group=group)
    if buf is not t:
        t.copy_(buf)
    _count(t, "all_reduce", group)
    return t


def mean_(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` averaged over ``group`` in place (psum, then ÷ size)."""
    return all_reduce_(t, group).div_(dist.get_world_size(group))


def broadcast_(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` from the group's rank 0 on every rank, in place."""
    src = 0 if group is None else dist.get_global_rank(group, 0)
    dist.broadcast(t, src=src, group=group)
    _count(t, "broadcast", group)
    return t


def gather_rows(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim`` in rank
    order, exactly."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    k = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * k
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    out.narrow(dim, r * k, k).copy_(x)
    return all_reduce_(out, group)


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.k = dim, x.shape[dim]
        ctx.rank = dist.get_rank(group)
        return gather_rows(x.detach(), group, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.k, ctx.k).contiguous(), None, None


def gather_columns(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """:func:`gather_rows` whose gradient is the rank's own block."""
    return _GatherColumns.apply(x, dim % x.dim(), group)


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(memory_format=torch.contiguous_format),
                           ctx.group), None


def sum_grad(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, with its gradient summed over ``group`` (nothing to do for an
    input that needs no gradient)."""
    return _SumGrad.apply(x, group) if x.requires_grad else x
