"""Frame-deduplicated replay for stacked-frame pixel envs
(≙ border_tpu/replay/frame_buffer.py).

Each 84×84 frame is stored once, in per-env columns
``frames[num_envs, capacity, 84, 84]`` uint8; both stacks of a sampled
transition are rebuilt at sample time by gathering consecutive frames.
Vectorised envs push in lockstep, so one write cursor (``total``, the
absolute step count) serves all columns.

Stack reconstruction at absolute step ``s`` of env ``e`` uses the union
window of the obs stack (base ``s``) and the next-obs stack (base
``s+1``): ``u_j = frames[e, ((s+1) − min(stack−j, age[e,s]+1)) % cap]``
for ``j = 0..stack``, oldest first; ``obs = u[:, :stack]`` and
``next_obs = u[:, 1:]``.  The ``age`` clamp replays the episode's first
frame for under-filled stacks, as the env's reset does.

Sampling is uniform over absolute steps ``[total − size + stack,
total − n_step)``, so every gathered window is resident.  With
``per=PerConfig()`` a device sum tree (:mod:`.sum_tree`) over the
``num_envs × capacity`` (env × slot) leaves draws instead.  Residency is
encoded as priority: a slot enters the tree, at the running max priority,
only once its whole sample window exists (the frame stack behind it,
``n_step`` successors ahead), and every push zeroes the slots whose
windows the new write invalidates.  The descent therefore never lands on a
non-resident transition, with no rejection step.

Differences from the JAX buffer:

- the ring is stored unpadded as ``[N, slots, 84, 84]`` (7056 B a frame, a
  multiple of 16): the TPU's ``(56, 128)`` tile padding is not copied;
- ``process_step`` and ``update_priority`` write the ring and the tree in
  place (the JAX state is immutable); copying a ring of GBs per push is
  not an option;
- ``total`` is a host int: it advances by one per push, so the write slot,
  the ``[lo, hi)`` draw range and the tree slots a push touches cost no
  device→host sync.  On a CUDA device the state also holds it as a device
  tensor (:mod:`border_tpu_torch.utils.counters`), from which the card's
  write slot, draw range, residency test and PER normalizer are computed,
  so a CUDA graph of a push or a sample replays them;
- every frame read of every mode goes through
  :func:`border_tpu_torch.ops.gather_frames`: the hand-written kernel on a
  CUDA ring, its plain version on a CPU one.  Union and slice mode launch
  it once a sample, separate mode and ``n_step > 1`` twice;
- ``weight`` is ``None`` for uniform draws (see ``TransitionBatch``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from border_tpu_torch.ops.frame_gather import gather_frames
from border_tpu_torch.replay.buffer import PerConfig, TransitionBatch
from border_tpu_torch.replay.sum_tree import SumTree, SumTreeState
from border_tpu_torch.utils.counters import (
    Count,
    count,
    new_counts,
    randint_below,
)
from border_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclasses.dataclass
class FrameReplayState:
    # [N, cap + slot_pad, H, W] uint8 — frame observed BEFORE acting; the
    # slice mode's mirror slots follow the ring
    frames: torch.Tensor
    act: torch.Tensor  # [N, cap] int32
    reward: torch.Tensor  # [N, cap] f32
    terminated: torch.Tensor  # [N, cap] bool
    truncated: torch.Tensor  # [N, cap] bool
    age: torch.Tensor  # [N, cap] int32 — step index within the episode
    total: int  # absolute steps pushed per env
    tree: Optional[SumTreeState] = None  # PER over (env × slot) leaves
    counts: Optional[torch.Tensor] = None  # (total,) on a CUDA device

    COUNTERS = ("total",)


class FrameReplayBuffer:
    """Replay for the Trainer: ``sample() -> TransitionBatch``.

    ``capacity`` is per env (global capacity = num_envs × capacity).
    """

    def __init__(
        self,
        capacity: int,
        num_envs: int,
        frame_hw: Tuple[int, int] = (84, 84),
        stack: int = 4,
        n_step: int = 1,
        gamma: float = 0.99,
        per: Optional[PerConfig] = None,
        sample_mode: str = "union",
        slice_group: int = 64,
        sort_samples: bool = False,
        device: DeviceLike = None,
    ):
        """``n_step > 1`` enables n-step backups: sampled batches carry
        ``reward = Σ γ^k r_{t+k}`` (stopped at the first episode boundary),
        ``next_obs`` from t+m, and ``discount = γ^m``.

        ``sample_mode``: "union" (default: ONE ascending ``stack+1``-wide
        gather shared by obs and next_obs, 5/8 the bytes of two stack
        gathers), "separate" (two stack-wide gathers) or "slice" (below).
        Union and slice are 1-step only; with ``n_step > 1`` the two stacks
        are gathered apart whatever the mode.  Per-sample VALUES are the
        same in all three.

        ``sample_mode="slice"``: a batch is ``batch_size // slice_group``
        independent groups; each group picks one absolute step (uniform
        over the uniform draw range) and one aligned block of
        ``slice_group`` consecutive env columns (uniform over blocks).  The
        ring gets ``stack + n_step`` mirror slots (a push writes slot p and,
        for p < pad, slot cap+p), so a sample's ``stack+1`` window never
        wraps and is one run of consecutive frames; the age clamp has the
        closed form ``u'_j = u[max(j, c)]``, ``c = max(stack−1−age, 0)``.
        The JAX buffer reads each group with one ``lax.dynamic_slice`` at
        offsets that live on the device.  In eager PyTorch a ``narrow``
        needs host ints, and reading them back is a device→host sync per
        sample, which a chunk does not allow itself.  So the group offsets
        are drawn on the device, turned into per-sample window indices
        there (the clamp applied to the indices), and read by the gather
        kernel as runs of consecutive frames.  Each transition's MARGINAL
        probability is uniform over the same (env, step) support as union
        mode; within a batch, group-mates share a timestep but come from
        different env instances.  Not available with PER or ``n_step > 1``.

        ``sort_samples``: reorder each uniform batch's draws ascending in
        (env, slot) before gathering.  A batch is a set, so this changes
        nothing but the order of the addresses read.
        """
        if sample_mode not in ("separate", "union", "slice"):
            raise ValueError(f"sample_mode must be 'separate', 'union' or "
                             f"'slice', got {sample_mode!r}")
        if sample_mode == "slice":
            if per is not None:
                raise ValueError("sample_mode='slice' is uniform-only; "
                                 "PER needs the per-leaf gather path")
            if n_step != 1:
                raise ValueError("sample_mode='slice' supports n_step=1 "
                                 "only (like 'union')")
            if num_envs % slice_group:
                raise ValueError(
                    f"slice_group ({slice_group}) must divide num_envs "
                    f"({num_envs})")
        self.capacity = capacity
        self.num_envs = num_envs
        self.frame_hw = tuple(frame_hw)
        self.stack = stack
        self.n_step = n_step
        self.gamma = gamma
        self.sample_mode = sample_mode
        self.slice_group = slice_group
        self.sort_samples = sort_samples
        # mirror pad: windows of stack+n_step slots never wrap the ring
        self.slot_pad = stack + n_step if sample_mode == "slice" else 0
        self.per = per
        self.device = resolve_device(device)
        self.tree = None
        if per is not None:
            self.tree = SumTree(num_envs * capacity, device=self.device)
            if self.tree.capacity != num_envs * capacity:
                raise ValueError(
                    "PER requires num_envs × capacity to be a power of two "
                    f"(got {num_envs * capacity}; next is {self.tree.capacity})"
                )
            if capacity <= stack + n_step:
                # also keeps the per-push activation slot (p − n_step) from
                # colliding with the invalidation slots (p .. p+stack−1)
                raise ValueError(
                    "PER needs capacity > stack + n_step "
                    f"(got {capacity} ≤ {stack} + {n_step})"
                )
            # per push: slots p .. p+stack−1 die, slot p − n_step enters
            self._push_offsets = torch.tensor(
                list(range(stack)) + [-n_step], device=self.device)
            self._push_enters = torch.tensor(
                [0.0] * stack + [1.0], device=self.device)
            self._env_base = (torch.arange(num_envs, device=self.device)
                              * capacity)[:, None]

    def with_num_envs(self, num_envs: int) -> "FrameReplayBuffer":
        """A copy of this buffer for ``num_envs`` env columns, every other
        setting the same (the slice group clamped to the columns, as in
        the JAX buffer): the per-rank replay shard of the port's
        ShardedTrainer, ``num_envs / world`` columns each, so the ranks'
        shards partition the global env axis.  A prioritized copy's tree
        has ``num_envs × capacity`` leaves, which must be a power of
        two."""
        return FrameReplayBuffer(
            capacity=self.capacity,
            num_envs=num_envs,
            frame_hw=self.frame_hw,
            stack=self.stack,
            n_step=self.n_step,
            gamma=self.gamma,
            per=self.per,
            sample_mode=self.sample_mode,
            slice_group=min(self.slice_group, num_envs),
            sort_samples=self.sort_samples,
            device=self.device,
        )

    def init(self, example=None) -> FrameReplayState:
        n, cap = self.num_envs, self.capacity
        z = lambda dtype, *shape: torch.zeros(  # noqa: E731
            (n, *shape), dtype=dtype, device=self.device
        )
        return FrameReplayState(
            frames=z(torch.uint8, cap + self.slot_pad, *self.frame_hw),
            act=z(torch.int32, cap),
            reward=z(torch.float32, cap),
            terminated=z(torch.bool, cap),
            truncated=z(torch.bool, cap),
            age=z(torch.int32, cap),
            total=0,
            tree=self.tree.init() if self.tree is not None else None,
            counts=new_counts(self.device, (0,)),
        )

    # -- ingest ------------------------------------------------------------
    @torch.no_grad()
    def process_step(
        self, state: FrameReplayState, prev_obs, action, ts, prev_ep_len
    ) -> FrameReplayState:
        """Push one lockstep vec-env transition, in place.

        prev_obs: [N, H, W, stack] uint8 (the stack's last channel is the
        current frame); ts: Timestep; prev_ep_len: [N] steps already taken
        this episode (0 right after reset).
        """
        if state.counts is not None:
            return self._push_on_card(state, prev_obs, action, ts, prev_ep_len)
        p = state.total % self.capacity
        if self.tree is not None:
            self._tree_push(state, p)
        frame = prev_obs[..., -1]
        state.frames[:, p] = frame
        if p < self.slot_pad:
            state.frames[:, self.capacity + p] = frame
        state.act[:, p] = action
        state.reward[:, p] = ts.reward
        state.terminated[:, p] = ts.terminated
        state.truncated[:, p] = ts.truncated
        state.age[:, p] = prev_ep_len
        state.total += 1
        return state

    def _push_on_card(self, state: FrameReplayState, prev_obs, action, ts,
                      prev_ep_len) -> FrameReplayState:
        """:meth:`process_step` at the slot of the device count: the same
        writes, as index copies.  The slice mode's mirror slot is slot
        ``cap + p`` where ``p < pad``, else ``p`` again (the same frame
        written twice)."""
        total = state.counts[0]
        p = (total % self.capacity).reshape(1)
        if self.tree is not None:
            self._tree_push(state, p[0])
        frame = prev_obs[..., -1].unsqueeze(1)  # [N, 1, H, W]
        if self.slot_pad:
            mirror = torch.where(p < self.slot_pad, p + self.capacity, p)
            state.frames.index_copy_(1, torch.cat([p, mirror]),
                                     frame.expand(-1, 2, -1, -1))
        else:
            state.frames.index_copy_(1, p, frame)
        for column, value in ((state.act, action), (state.reward, ts.reward),
                              (state.terminated, ts.terminated),
                              (state.truncated, ts.truncated),
                              (state.age, prev_ep_len)):
            column.index_copy_(1, p, value.to(column.dtype)[:, None])
        state.total += 1
        total.add_(1)
        return state

    def _tree_push(self, state: FrameReplayState, p: Count) -> None:
        """Per-push PER residency maintenance, one batched tree update:

        - zero slots ``p .. p+stack−1`` for every env: ``p`` holds the new
          (still windowless) step, and the stacks of the ``stack−1`` slots
          after it now cross the overwrite point,
        - activate step ``total − n_step`` (its whole window just became
          resident) at the running max priority; the first ``stack`` steps
          of the run stay out, matching the uniform draw range.
        """
        slots = (self._push_offsets + p) % self.capacity  # [stack + 1]
        # host ints on the CPU, device scalars on the card
        enters = count(state, "total") - self.n_step >= self.stack
        if torch.is_tensor(enters):
            prio = self._push_enters * torch.where(
                enters, state.tree.max_priority, 0.0)
        else:
            prio = self._push_enters * (state.tree.max_priority if enters else 0.0)
        n = self.num_envs
        self.tree.update(
            state.tree,
            (self._env_base + slots[None, :]).reshape(-1),
            prio[None, :].expand(n, -1).reshape(-1),
        )

    @property
    def size_attr(self) -> str:
        """The state's counter of steps pushed (``total``)."""
        return "total"

    def fill(self, state: FrameReplayState) -> int:
        """Sampleable transitions currently resident (global count); matches
        ``sample``'s draw range ``[lo, hi)``."""
        size = min(state.total, self.capacity)
        return max(size - self.stack - self.n_step, 0) * self.num_envs

    def _draw_range(self, state: FrameReplayState) -> Tuple[Count, Count]:
        """``[lo, hi)``: host ints on the CPU, device scalars on the card."""
        total = count(state, "total")
        if torch.is_tensor(total):
            lo = total - total.clamp_max(self.capacity) + self.stack
            return lo, torch.maximum(total - self.n_step, lo + 1)
        size = min(total, self.capacity)
        lo = total - size + self.stack
        return lo, max(total - self.n_step, lo + 1)

    def _fill_count(self, state: FrameReplayState) -> Count:
        """:meth:`fill` of the device count on the card."""
        total = count(state, "total")
        if not torch.is_tensor(total):
            return self.fill(state)
        size = total.clamp_max(self.capacity)
        return (size - self.stack - self.n_step).clamp_min(0) * self.num_envs

    def _randint(self, lo: Count, hi: Count, n: int, gen) -> torch.Tensor:
        """``n`` steps uniform over ``[lo, hi)``."""
        if torch.is_tensor(lo):
            return lo + randint_below(hi - lo, (n,), gen)
        return torch.randint(lo, hi, (n,), generator=gen, device=self.device)

    # -- sampling ----------------------------------------------------------
    def _gather_rows(self, state: FrameReplayState, e: torch.Tensor,
                     idx: torch.Tensor) -> torch.Tensor:
        """frames[e, idx] → [B, K, H, W] (K = idx.shape[1]): the frame
        gather kernel on a CUDA ring, its plain version on a CPU one.  The
        stride is the STORED slot count (the mirror pad included)."""
        flat = state.frames.view(-1, *self.frame_hw)
        flat_idx = (e[:, None] * state.frames.shape[1] + idx).to(torch.int32)
        return gather_frames(flat, flat_idx)

    def _gather_stack(self, state: FrameReplayState, e: torch.Tensor,
                      s_abs: torch.Tensor, ages: torch.Tensor) -> torch.Tensor:
        """frames[e, window(s_abs)] → [B, H, W, stack], the window clamped
        into the episode (its first frame repeated when short)."""
        back = torch.arange(self.stack - 1, -1, -1, device=e.device)
        s_k = s_abs[:, None] - torch.minimum(back[None, :], ages[:, None])
        g = self._gather_rows(state, e, s_k % self.capacity)
        return g.permute(0, 2, 3, 1)

    def _gather_union(self, state: FrameReplayState, e: torch.Tensor,
                      s_abs: torch.Tensor, ages: torch.Tensor):
        """(obs, next_obs) for 1-step samples via ONE union gather of
        ``stack + 1`` frames, oldest first.  Frame identity under the age
        clamp: obs frame k = (s+1) − min(stack−k, age+1) = u_k and next
        frame k = (s+1) − min(stack−1−k, age+1) = u_{k+1}.  Both stacks are
        NHWC views of the one ``[B, stack+1, H, W]`` gather result."""
        js = torch.arange(self.stack + 1, device=e.device)
        s_j = (s_abs + 1)[:, None] - torch.minimum(
            (self.stack - js)[None, :], (ages + 1)[:, None]
        )
        return self._split_union(self._gather_rows(state, e, s_j % self.capacity))

    def _gather_slice(self, state: FrameReplayState, e: torch.Tensor,
                      s_abs: torch.Tensor, ages: torch.Tensor):
        """The union window read as one run of ``stack + 1`` consecutive
        stored slots starting at ``w0 = (s − (stack−1)) % cap`` (the mirror
        pad keeps the run from wrapping), with the age clamp in closed form
        on the indices: position j reads slot ``w0 + max(j, c)``,
        ``c = max(stack−1−age, 0)``.  Value-identical to
        :meth:`_gather_union`."""
        js = torch.arange(self.stack + 1, device=e.device)
        w0 = (s_abs - (self.stack - 1)) % self.capacity
        c = (self.stack - 1 - ages).clamp_min(0)
        idx = w0[:, None] + torch.maximum(js[None, :], c[:, None])
        return self._split_union(self._gather_rows(state, e, idx))

    def _split_union(self, g: torch.Tensor):
        return (g[:, : self.stack].permute(0, 2, 3, 1),
                g[:, 1:].permute(0, 2, 3, 1))

    def draw(self, state: FrameReplayState, gen: torch.Generator,
             batch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Uniform draw: env ``e`` in ``[0, N)`` and absolute step ``s`` in
        ``[total − size + stack, total − n_step)``, both ``[B]`` int64.  In
        slice mode one (env block, step) pair per group of ``slice_group``
        samples."""
        lo, hi = self._draw_range(state)
        dev = state.frames.device
        if self.sample_mode == "slice":
            g = self.slice_group
            if batch_size % g:
                raise ValueError(
                    f"slice_group ({g}) must divide batch_size ({batch_size})")
            e0 = g * torch.randint(0, self.num_envs // g, (batch_size // g,),
                                   generator=gen, device=dev)
            s_g = self._randint(lo, hi, batch_size // g, gen)
            e = (e0[:, None] + torch.arange(g, device=dev)[None, :]).reshape(-1)
            return e, s_g.repeat_interleave(g)
        e = torch.randint(0, self.num_envs, (batch_size,), generator=gen,
                          device=dev)
        s = self._randint(lo, hi, batch_size, gen)
        if self.sort_samples:
            order = torch.argsort(e * self.capacity + s % self.capacity)
            e, s = e[order], s[order]
        return e, s

    @torch.no_grad()
    def draw_per(self, state: FrameReplayState, gen: Optional[torch.Generator],
                 batch_size: int, n_opts: Count = 0,
                 u: Optional[torch.Tensor] = None):
        """Prioritized draw over the (env × slot) leaves: ``(e, s, weight)``.
        Residency is guaranteed by the zero-priority maintenance in
        :meth:`_tree_push`.  ``u`` injects the descent's uniform draws."""
        leaf = self.tree.sample(state.tree, batch_size, gen=gen, u=u)
        e = leaf // self.capacity
        p_leaf = leaf % self.capacity
        # most recent absolute step congruent to this slot
        total = count(state, "total")
        s = (total - 1) - ((total - 1 - p_leaf) % self.capacity)
        weight = self.tree.weights(
            state.tree, leaf, self._fill_count(state), self.per.beta(n_opts),
            self.per.normalize_all,
        )
        return e, s, weight

    @torch.no_grad()
    def sample_at(self, state: FrameReplayState, e: torch.Tensor,
                  s: torch.Tensor,
                  weight: Optional[torch.Tensor] = None) -> TransitionBatch:
        """The batch for drawn envs ``e`` and absolute steps ``s``."""
        cap = self.capacity
        p = s % cap
        ages = state.age[e, p]
        batch = dict(
            act=state.act[e, p],
            weight=weight,
            ix_sample=(e * cap + p).to(torch.int32),
        )
        if self.n_step == 1:
            if self.sample_mode == "union":
                obs, next_obs = self._gather_union(state, e, s, ages)
            elif self.sample_mode == "slice":
                obs, next_obs = self._gather_slice(state, e, s, ages)
            else:
                obs = self._gather_stack(state, e, s, ages)
                next_obs = self._gather_stack(state, e, s + 1, ages + 1)
            return TransitionBatch(
                obs=obs, next_obs=next_obs, reward=state.reward[e, p],
                terminated=state.terminated[e, p],
                truncated=state.truncated[e, p], **batch,
            )

        # --- n-step accumulation, stopped at the first episode boundary
        obs = self._gather_stack(state, e, s, ages)
        ks = torch.arange(self.n_step, device=e.device)  # [n]
        pk = (s[:, None] + ks[None, :]) % cap
        ek = e[:, None]
        done_k = state.terminated[ek, pk] | state.truncated[ek, pk]
        # continuing[b, k] = no boundary strictly before step k
        done_i = done_k.to(torch.int32)
        continuing = ((done_i.cumsum(1) - done_i) == 0).float()
        gammas = self.gamma ** ks.float()
        reward_n = (state.reward[ek, pk] * gammas[None, :] * continuing).sum(1)
        m = continuing.sum(1).to(torch.int32)  # steps taken ≤ n
        p_last = (s + m - 1) % cap
        return TransitionBatch(
            obs=obs,
            next_obs=self._gather_stack(state, e, s + m, ages + m),
            reward=reward_n,
            terminated=state.terminated[e, p_last],
            truncated=state.truncated[e, p_last],
            discount=self.gamma ** m.float(),
            **batch,
        )

    def sample(self, state: FrameReplayState, gen: torch.Generator,
               batch_size: int, n_opts: Optional[Count] = None) -> TransitionBatch:
        if self.per is not None:
            return self.sample_at(
                state, *self.draw_per(state, gen, batch_size,
                                   0 if n_opts is None else n_opts))
        return self.sample_at(state, *self.draw(state, gen, batch_size))

    @torch.no_grad()
    def update_priority(self, state: FrameReplayState, ix_sample, td_err):
        """|td|^α priority feedback (≙ update_priority, base.rs:413-426), in
        place; no-op when uniform.  A leaf sampled twice in the batch keeps
        the larger of its two priorities (:meth:`SumTree.update`)."""
        if self.per is not None:
            p = (td_err.abs() + self.per.eps) ** self.per.alpha
            self.tree.update(state.tree, ix_sample, p)
        return state

    def diagnostics(self, state: FrameReplayState) -> Dict[str, torch.Tensor]:
        size = min(state.total, self.capacity)
        return {
            "num_terminated": state.terminated[:, :size].sum(),
            "sum_rewards": state.reward[:, :size].sum(),
            "size": size * self.num_envs,
        }
