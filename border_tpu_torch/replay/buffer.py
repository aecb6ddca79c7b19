"""Ring replay buffer with uniform and prioritized sampling, and the
transition containers (≙ border_tpu/replay/buffer.py).

- storage is a ``Transition`` of ``[capacity, ...]`` device tensors,
  allocated from one example transition; a dict observation (the goal
  envs') is a dict of such tensors, where the JAX buffer maps over a
  pytree,
- ``push`` writes a whole batch of transitions at the ring cursor (one push
  per vectorised env step),
- ``sample`` is a batched random read: plain tensor indexing, as the JAX
  buffer's reads are XLA gathers outside any hand-written kernel,
- PER uses the device :class:`~border_tpu_torch.replay.sum_tree.SumTree`
  with β annealed linearly β₀→β_final over ``n_opts_final`` optimizer steps,
- ``update_priority`` writes ``(|td| + eps)^α`` back into the tree.

As in the port's frame buffer, ``push`` and ``update_priority`` write in
place and return the same state, ``cursor`` and ``size`` are host ints
(they advance by fixed amounts, so the draw range costs no device→host
sync), and a uniform batch carries ``weight=None``.  On a CUDA device the
state also holds ``cursor`` and ``size`` as a device tensor
(:mod:`border_tpu_torch.utils.counters`): the card's push slots and draw
ranges read it, so a CUDA graph of a push or a sample replays them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from border_tpu_torch.envs.pixel import true_div
from border_tpu_torch.replay.sum_tree import SumTree, SumTreeState
from border_tpu_torch.utils.counters import (
    Count,
    count,
    new_counts,
    randint_below,
)
from border_tpu_torch.utils.device import DeviceLike, resolve_device


def map_obs(fn, x):
    """``fn`` applied to a tensor, or to each entry of a dict of them."""
    if isinstance(x, dict):
        return {k: fn(v) for k, v in x.items()}
    return fn(x)


@dataclasses.dataclass
class Transition:
    """One (possibly batched) environment transition."""

    obs: Any
    act: Any
    next_obs: Any
    reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor


@dataclasses.dataclass
class TransitionBatch(Transition):
    """Sampled batch: transition + PER bookkeeping.

    ``unpack()`` returns the 8-tuple ``(obs, act, next_obs, reward,
    terminated, truncated, ix_sample, weight)``.  ``discount`` is the n-step
    bootstrap factor γ^m (None for 1-step batches).  ``weight`` holds the
    importance weights of a prioritized draw; ``None`` means "all ones"
    (uniform replay), where the JAX buffer returns a vector of ones: the
    loss is the same and the multiply is saved.
    """

    weight: Optional[torch.Tensor] = None
    ix_sample: Optional[torch.Tensor] = None
    discount: Optional[torch.Tensor] = None

    def unpack(self):
        return (
            self.obs,
            self.act,
            self.next_obs,
            self.reward,
            self.terminated,
            self.truncated,
            self.ix_sample,
            self.weight,
        )

    def __len__(self):
        return self.reward.shape[0]


@dataclasses.dataclass(frozen=True)
class PerConfig:
    """≙ PerConfig (generic_replay_buffer/config.rs:44-120); same defaults."""

    alpha: float = 0.6
    beta_0: float = 0.4
    beta_final: float = 1.0
    n_opts_final: int = 500_000
    normalize_all: bool = True
    eps: float = 1e-6

    def beta(self, n_opts: Count):
        """Linear β annealing (≙ IwScheduler::beta, iw_scheduler.rs:6-46) in
        float32 like the JAX version: a float of a host int, a 0-dim tensor
        of a device count (the same float32 operations)."""
        f32 = np.float32
        if torch.is_tensor(n_opts):
            frac = true_div(n_opts.float(), float(f32(self.n_opts_final)))
            return (frac.clamp(0.0, 1.0) * float(f32(self.beta_final - self.beta_0))
                    + float(f32(self.beta_0)))
        frac = np.clip(f32(n_opts) / f32(self.n_opts_final), f32(0), f32(1))
        return float(f32(self.beta_0) + frac * f32(self.beta_final - self.beta_0))


@dataclasses.dataclass
class ReplayBufferState:
    data: Transition  # fields of [capacity, ...] tensors
    cursor: int  # next write position
    size: int  # number of valid entries
    tree: Optional[SumTreeState] = None  # PER state (None when uniform)
    counts: Optional[torch.Tensor] = None  # (cursor, size) on a CUDA device

    COUNTERS = ("cursor", "size")


class ReplayBuffer:
    """Flat ring buffer for the Trainer: ``sample() -> TransitionBatch``."""

    def __init__(
        self,
        capacity: int,
        per: Optional[PerConfig] = None,
        n_step: int = 1,
        gamma: float = 0.99,
        stride: int = 1,
        device: DeviceLike = None,
    ):
        """``n_step > 1`` makes ``sample`` return n-step backups
        (``reward = Σ γ^k r_{t+k}`` stopped at the first episode boundary,
        ``next_obs`` from t+m, ``discount = γ^m``).

        ``stride`` is the ring distance between a transition and the SAME
        env's next transition: 1 for sequentially pushed data, ``num_envs``
        for lockstep vec-env pushes (each vec step pushes a ``[num_envs]``
        batch)."""
        self.capacity = capacity
        self.per = per
        self.n_step = n_step
        self.gamma = gamma
        self.stride = stride
        self.device = resolve_device(device)
        self.tree = SumTree(capacity, device=self.device) if per is not None else None
        if self.tree is not None and self.tree.capacity != capacity:
            raise ValueError(
                "PER requires a power-of-two capacity "
                f"(got {capacity}; next is {self.tree.capacity})"
            )
        if n_step > 1 and capacity < (n_step + 1) * stride:
            raise ValueError("capacity too small for n_step × stride window")

    def init(self, example: Transition) -> ReplayBufferState:
        """Allocate ``[capacity, ...]`` storage from one example transition
        (a shape and dtype template)."""
        def zeros(x):
            x = torch.as_tensor(x)
            return torch.zeros((self.capacity, *x.shape), dtype=x.dtype,
                               device=self.device)

        data = Transition(**{
            f.name: map_obs(zeros, getattr(example, f.name))
            for f in dataclasses.fields(Transition)
        })
        return ReplayBufferState(
            data=data, cursor=0, size=0,
            tree=self.tree.init() if self.tree is not None else None,
            counts=new_counts(self.device, (0, 0)),
        )

    # -- ingest ------------------------------------------------------------
    @torch.no_grad()
    def push(self, state: ReplayBufferState, batch: Transition) -> ReplayBufferState:
        """Write B transitions at the ring cursor (batch axis leading), in
        place.  A push that does not wrap is one slice copy per field."""
        n = batch.reward.shape[0]
        c, cap = state.cursor, self.capacity
        wraps = c + n > cap
        idx = None
        if state.counts is not None:  # the device cursor: always indexed
            idx = (state.counts[0] + torch.arange(n, device=self.device)) % cap
            wraps = True
        elif wraps or self.tree is not None:
            idx = torch.arange(c, c + n, device=self.device) % cap
        where = idx if wraps else slice(c, c + n)

        def write(store, new):
            store[where] = new.to(store.dtype)

        for f in dataclasses.fields(Transition):
            store, new = getattr(state.data, f.name), getattr(batch, f.name)
            if isinstance(store, dict):
                for k in store:
                    write(store[k], new[k])
            else:
                write(store, new)
        if self.tree is not None:
            # fresh transitions enter at the running max priority
            self.tree.update(state.tree, idx, state.tree.max_priority.expand(n))
        state.cursor = (c + n) % cap
        state.size = min(state.size + n, cap)
        if state.counts is not None:
            state.counts[0].add_(n).remainder_(cap)
            state.counts[1].add_(n).clamp_max_(cap)
        return state

    def process_step(
        self, state: ReplayBufferState, prev_obs, action, ts, prev_ep_len
    ) -> ReplayBufferState:
        """Convert one vec-env Timestep into the stored format and push."""
        return self.push(state, Transition(
            obs=prev_obs, act=action, next_obs=ts.final_obs, reward=ts.reward,
            terminated=ts.terminated, truncated=ts.truncated,
        ))

    def fill(self, state: ReplayBufferState) -> int:
        """Sampleable transitions: for n-step buffers only positions whose
        whole window is written count (matches ``draw``'s range
        ``d ∈ [(n−1)·stride, size)``), so warmup cannot pass while samples
        would land on unwritten zero slots."""
        if self.n_step > 1:
            return max(state.size - (self.n_step - 1) * self.stride, 0)
        return state.size

    # -- sampling ----------------------------------------------------------
    def draw(self, state: ReplayBufferState, gen: Optional[torch.Generator],
             batch_size: int, raw: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Uniform draw of storage indices ``[B]`` int64.  ``raw`` injects
        the integers the generator would give: the index itself for 1-step
        buffers, the "steps before the cursor" ``d`` for n-step ones."""
        dev = self.device
        if state.counts is not None:
            return self._draw_on_card(state, gen, batch_size, raw)
        if self.n_step > 1:
            # d ∈ [(n−1)·stride, size): the whole n-step window is written
            lo = (self.n_step - 1) * self.stride
            hi = max(state.size, lo + 1)
            d = raw if raw is not None else torch.randint(
                lo, hi, (batch_size,), generator=gen, device=dev)
            # under-filled guard: clamp into the written region (the window
            # mask in _nstep_batch shortens windows that would cross the
            # oldest data); fill() keeps warmup from sampling until real
            # windows exist
            d = d.clamp_max(max(state.size - 1, 0))
            return (state.cursor - 1 - d) % self.capacity
        if raw is not None:
            return raw
        return torch.randint(0, max(state.size, 1), (batch_size,),
                             generator=gen, device=dev)

    def _draw_on_card(self, state: ReplayBufferState, gen, batch_size: int,
                      raw: Optional[torch.Tensor]) -> torch.Tensor:
        """:meth:`draw` with the cursor and size of the device counts (the
        same ranges, drawn by :func:`randint_below`)."""
        cursor, size = state.counts[0], state.counts[1]
        if self.n_step > 1:
            lo = (self.n_step - 1) * self.stride
            d = raw if raw is not None else lo + randint_below(
                (size - lo).clamp_min(1), (batch_size,), gen)
            d = torch.minimum(d, (size - 1).clamp_min(0))
            return (cursor - 1 - d) % self.capacity
        if raw is not None:
            return raw
        return randint_below(size.clamp_min(1), (batch_size,), gen)

    @torch.no_grad()
    def draw_per(self, state: ReplayBufferState, gen: Optional[torch.Generator],
                 batch_size: int, n_opts: Count = 0,
                 u: Optional[torch.Tensor] = None):
        """Prioritized draw: ``(idx, weight)``.  ``u`` injects the descent's
        uniform draws."""
        idx = self.tree.sample(state.tree, batch_size, gen=gen, u=u)
        size = count(state, "size")
        if torch.is_tensor(size):
            idx = torch.minimum(idx, size.clamp_min(1) - 1)
        else:
            idx = idx.clamp_max(max(size, 1) - 1)
        weight = self.tree.weights(
            state.tree, idx, size, self.per.beta(n_opts),
            self.per.normalize_all,
        )
        return idx, weight

    @torch.no_grad()
    def sample_at(self, state: ReplayBufferState, idx: torch.Tensor,
                  weight: Optional[torch.Tensor] = None) -> TransitionBatch:
        """The batch for drawn storage indices ``idx``."""
        if self.n_step > 1:
            return self._nstep_batch(state, idx, weight)
        data = state.data
        return TransitionBatch(
            obs=map_obs(lambda x: x[idx], data.obs), act=data.act[idx],
            next_obs=map_obs(lambda x: x[idx], data.next_obs),
            reward=data.reward[idx],
            terminated=data.terminated[idx], truncated=data.truncated[idx],
            weight=weight, ix_sample=idx.to(torch.int32),
        )

    def _nstep_batch(self, state, idx, weight) -> TransitionBatch:
        """n-step accumulation along each sampled env's timeline
        (consecutive same-env transitions sit ``stride`` apart in the
        ring), stopped at the first episode boundary and at the write
        cursor (PER-sampled indices may sit close to it)."""
        data, cap = state.data, self.capacity
        ks = torch.arange(self.n_step, device=idx.device)  # [n]
        pk = (idx[:, None] + ks[None, :] * self.stride) % cap
        # steps-before-cursor of the base transition bounds the window
        d = (count(state, "cursor") - 1 - idx) % cap
        valid = ks[None, :] * self.stride <= d[:, None]
        r_k = data.reward[pk]
        done_k = data.terminated[pk] | data.truncated[pk]
        done_i = done_k.to(torch.int32)
        prior_done = done_i.cumsum(1) - done_i
        continuing = ((prior_done == 0) & valid).float()
        gammas = self.gamma ** ks.float()
        reward_n = (r_k * gammas[None, :] * continuing).sum(1)
        m = continuing.sum(1).to(torch.int32)  # ≥ 1 (k=0 valid)
        p_last = (idx + (m - 1) * self.stride) % cap
        return TransitionBatch(
            obs=map_obs(lambda x: x[idx], data.obs),
            act=data.act[idx],
            next_obs=map_obs(lambda x: x[p_last], data.next_obs),
            reward=reward_n,
            terminated=data.terminated[p_last],
            truncated=data.truncated[p_last],
            weight=weight,
            ix_sample=idx.to(torch.int32),
            discount=self.gamma ** m.float(),
        )

    def sample(self, state: ReplayBufferState, gen: torch.Generator,
               batch_size: int, n_opts: Optional[Count] = None) -> TransitionBatch:
        if self.per is not None:
            return self.sample_at(
                state, *self.draw_per(state, gen, batch_size,
                                   0 if n_opts is None else n_opts))
        return self.sample_at(state, self.draw(state, gen, batch_size))

    # -- priority feedback -------------------------------------------------
    @torch.no_grad()
    def update_priority(self, state: ReplayBufferState, ix_sample, td_err):
        """``(|td| + eps)^α`` into the tree, in place; no-op when uniform."""
        if self.per is not None:
            p = (td_err.abs() + self.per.eps) ** self.per.alpha
            self.tree.update(state.tree, ix_sample, p)
        return state

    def diagnostics(self, state: ReplayBufferState) -> Dict[str, Any]:
        n = state.size
        return {
            "num_terminated": state.data.terminated[:n].sum(),
            "sum_rewards": state.data.reward[:n].sum(),
            "size": n,
        }
