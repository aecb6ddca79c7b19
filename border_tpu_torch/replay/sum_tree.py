"""Vectorised device-side sum tree for prioritized experience replay
(≙ border_tpu/replay/sum_tree.py).

Layout: ``tree[2 * capacity]`` float32 (capacity is a power of two).
``tree[1]`` is the root (total mass), leaves live at ``tree[capacity + i]``,
``tree[0]`` is unused.  Stored leaf values are the already-exponentiated
priorities ``p = (|td| + eps)^alpha``.  A min tree of the same shape gives
the "normalize over All" importance weights their maximum.

Batched updates and a batched prefix-sum descent over all ``depth`` =
log2(capacity) levels, with no device→host sync: on the card each is one
launch of a hand-written kernel, on the CPU a plain loop of a few torch ops
a level (:mod:`border_tpu_torch.ops.sum_tree`; the two agree bit for bit).
``update`` writes the trees in place and returns the same state, as the
port's ring does.

Two things differ from the JAX tree, both where its result is unspecified
or faulty:

- **duplicate indices with different priorities** in one ``update``: JAX
  leaves the winner of conflicting ``.at[].set`` writes unspecified, and
  ``index_put_`` on CUDA is order-dependent.  Here the leaf takes the
  **maximum** of the priorities written to it (``scatter_reduce_`` with
  ``amax``), on every device;
- **the descent never enters a right subtree whose sum is zero.**  A mass
  point can reach the root's total: ``(B − 1) + u`` rounds up to ``B`` in
  float32 for the top stratum once ``u ≥ 1 − 2^-16`` at ``B`` = 512 (one
  batch in 65,536), and the JAX descent then walks right at
  every level and returns the last leaf, dead unless the ring is full
  (rounding below the root can do the same inside a subtree).  With the
  extra test the sampled leaf always has mass while the root has;
  wherever the JAX descent lands on a live leaf, this one lands on the
  same leaf.  Both children come from one paired read, so the test costs
  no further read.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from border_tpu_torch.ops.sum_tree import load, sum_tree_sample, sum_tree_update
from border_tpu_torch.utils.counters import Count
from border_tpu_torch.utils.device import DeviceLike, resolve_device


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclasses.dataclass
class SumTreeState:
    sum_tree: torch.Tensor  # [2 * cap] f32, internal nodes are subtree sums
    min_tree: torch.Tensor  # [2 * cap] f32, internal nodes are subtree mins
    # running max of raw (exponentiated) priorities; a device scalar, since
    # reading it on the host would cost a sync per push
    max_priority: torch.Tensor


class SumTree:
    """Static-config companion of :class:`SumTreeState`."""

    def __init__(self, capacity: int, device: DeviceLike = None):
        self.capacity = _next_pow2(capacity)
        self.depth = self.capacity.bit_length() - 1  # log2(capacity)
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            load()  # the kernels' build belongs to set-up, not the first chunk

    def init(self) -> SumTreeState:
        return SumTreeState(
            sum_tree=torch.zeros(2 * self.capacity, dtype=torch.float32,
                                 device=self.device),
            min_tree=torch.full((2 * self.capacity,), float("inf"),
                                dtype=torch.float32, device=self.device),
            max_priority=torch.ones((), dtype=torch.float32, device=self.device),
        )

    @torch.no_grad()
    def update(self, state: SumTreeState, indices: torch.Tensor,
               priorities: torch.Tensor) -> SumTreeState:
        """Batched leaf write + bottom-up recompute, in place.

        Each level recomputes the parents from both children (``left +
        right``, in that order, as the JAX tree does), so duplicate indices
        write the same value there.  At the leaves a duplicated index keeps
        the maximum of its priorities (see the module docstring).

        A zero priority marks a DEAD leaf (FrameReplayBuffer's residency
        maintenance): it gets no sampling mass and enters the min tree as
        +inf, like an unwritten leaf.  Live priorities are always > 0.
        """
        sum_tree_update(state.sum_tree, state.min_tree, state.max_priority,
                        indices.long(), priorities.float())
        return state

    def total(self, state: SumTreeState) -> torch.Tensor:
        return state.sum_tree[1]

    def min_priority(self, state: SumTreeState) -> torch.Tensor:
        return state.min_tree[1]

    @torch.no_grad()
    def sample(self, state: SumTreeState, batch_size: int,
               gen: Optional[torch.Generator] = None,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Stratified prefix-sum inversion (≙ sum_tree.rs sample/get): one
        mass point per stratum of total/batch_size, then all lanes descend
        one level per round.  ``u`` [batch_size] injects the uniform draws
        (float32 in [0, 1)); otherwise they come from ``gen``.  Returns leaf
        indices, int64."""
        if u is None:
            u = torch.rand((batch_size,), generator=gen, dtype=torch.float32,
                           device=state.sum_tree.device)
        return sum_tree_sample(state.sum_tree, u)

    @torch.no_grad()
    def weights(self, state: SumTreeState, indices: torch.Tensor,
                n_valid: Count, beta: Union[float, torch.Tensor],
                normalize_all: bool = True) -> torch.Tensor:
        """Importance weights ``(N·P(i))^{-β}``, normalized by the max weight
        over All (via the min tree) or over the Batch
        (≙ sum_tree.rs:116-156).  ``n_valid`` and ``beta`` are host numbers
        on the CPU path and device scalars on the card's."""
        total = self.total(state).clamp_min(1e-12)
        p = state.sum_tree[indices.long() + self.capacity] / total
        n = n_valid.float() if torch.is_tensor(n_valid) else float(n_valid)
        w = (n * p.clamp_min(1e-12)) ** (-beta)
        if normalize_all:
            p_min = self.min_priority(state).clamp_min(1e-12) / total
            w_max = (n * p_min) ** (-beta)
        else:
            w_max = w.max()
        return w / w_max.clamp_min(1e-12)
