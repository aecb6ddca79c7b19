"""Frame-deduplicated replay for stacked-frame pixel envs
(≙ border_tpu/replay/frame_buffer.py, main-path modes).

Each 84×84 frame is stored once, in per-env columns
``frames[num_envs, capacity, 84, 84]`` uint8; both stacks of a sampled
transition are rebuilt at sample time by gathering ``stack + 1``
consecutive frames.  Vectorised envs push in lockstep, so one write cursor
(``total``, the absolute step count) serves all columns.

Stack reconstruction at absolute step ``s`` of env ``e`` uses the union
window of the obs stack (base ``s``) and the next-obs stack (base
``s+1``): ``u_j = frames[e, ((s+1) − min(stack−j, age[e,s]+1)) % cap]``
for ``j = 0..stack``, oldest first; ``obs = u[:, :stack]`` and
``next_obs = u[:, 1:]``.  The ``age`` clamp replays the episode's first
frame for under-filled stacks, as the env's reset does.

Differences from the JAX buffer:

- the ring is stored unpadded as ``[N, cap, 84, 84]`` (7056 B a frame, a
  multiple of 16): the TPU's ``(56, 128)`` tile padding is not copied;
- ``process_step`` writes the ring in place (the JAX state is immutable);
  copying a 1.85 GB ring per push is not an option;
- ``total`` is a host int: it advances by one per push, so the write slot
  and the ``[lo, hi)`` draw range cost no device→host sync;
- on a CUDA tensor the union window is read by the hand-written
  frame-gather kernel (:func:`border_tpu_torch.ops.gather_frames`).

Ported so far: uniform sampling, ``sample_mode="union"``, ``n_step=1``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from border_tpu_torch.ops.frame_gather import gather_frames
from border_tpu_torch.replay.buffer import TransitionBatch
from border_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclasses.dataclass
class FrameReplayState:
    frames: torch.Tensor  # [N, cap, H, W] uint8 — frame observed BEFORE acting
    act: torch.Tensor  # [N, cap] int32
    reward: torch.Tensor  # [N, cap] f32
    terminated: torch.Tensor  # [N, cap] bool
    truncated: torch.Tensor  # [N, cap] bool
    age: torch.Tensor  # [N, cap] int32 — step index within the episode
    total: int  # absolute steps pushed per env


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
        per=None,
        sample_mode: str = "union",
        slice_group: int = 64,
        sort_samples: bool = False,
        device: DeviceLike = None,
    ):
        """``per``, ``n_step > 1``, ``sample_mode`` "separate"/"slice" and
        ``sort_samples`` are the JAX buffer's other modes; each raises
        ``ValueError`` until the ROADMAP item it names ports it.
        ``slice_group`` only matters to the slice mode."""
        if per is not None:
            raise ValueError("prioritized replay (per=) ports with ROADMAP A.8")
        if n_step != 1:
            raise ValueError("n_step > 1 ports with ROADMAP A.9")
        if sample_mode in ("separate", "slice"):
            raise ValueError(
                f"sample_mode={sample_mode!r} ports with ROADMAP A.9"
            )
        if sample_mode != "union":
            raise ValueError(f"sample_mode must be 'separate', 'union' or "
                             f"'slice', got {sample_mode!r}")
        if sort_samples:
            raise ValueError("sort_samples ports with ROADMAP A.9")
        self.capacity = capacity
        self.num_envs = num_envs
        self.frame_hw = tuple(frame_hw)
        self.stack = stack
        self.n_step = n_step
        self.gamma = gamma
        self.device = resolve_device(device)

    def init(self, example=None) -> FrameReplayState:
        n, cap = self.num_envs, self.capacity
        z = lambda dtype, *shape: torch.zeros(  # noqa: E731
            (n, cap, *shape), dtype=dtype, device=self.device
        )
        return FrameReplayState(
            frames=z(torch.uint8, *self.frame_hw),
            act=z(torch.int32),
            reward=z(torch.float32),
            terminated=z(torch.bool),
            truncated=z(torch.bool),
            age=z(torch.int32),
            total=0,
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
        p = state.total % self.capacity
        state.frames[:, p] = prev_obs[..., -1]
        state.act[:, p] = action
        state.reward[:, p] = ts.reward
        state.terminated[:, p] = ts.terminated
        state.truncated[:, p] = ts.truncated
        state.age[:, p] = prev_ep_len
        state.total += 1
        return state

    def fill(self, state: FrameReplayState) -> int:
        """Sampleable transitions currently resident (global count); matches
        ``sample``'s draw range ``[lo, hi)``."""
        size = min(state.total, self.capacity)
        return max(size - self.stack - self.n_step, 0) * self.num_envs

    def _draw_range(self, state: FrameReplayState) -> Tuple[int, int]:
        size = min(state.total, self.capacity)
        lo = state.total - size + self.stack
        return lo, max(state.total - self.n_step, lo + 1)

    # -- sampling ----------------------------------------------------------
    def _gather_rows(self, state: FrameReplayState, e: torch.Tensor,
                     idx: torch.Tensor) -> torch.Tensor:
        """frames[e, idx] → [B, K, H, W] (K = idx.shape[1]): the frame
        gather kernel on a CUDA ring, its plain version on a CPU one."""
        flat = state.frames.view(-1, *self.frame_hw)
        flat_idx = (e[:, None] * self.capacity + idx).to(torch.int32)
        return gather_frames(flat, flat_idx)

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
        g = self._gather_rows(state, e, s_j % self.capacity)
        obs = g[:, : self.stack].permute(0, 2, 3, 1)
        next_obs = g[:, 1:].permute(0, 2, 3, 1)
        return obs, next_obs

    def draw(self, state: FrameReplayState, gen: torch.Generator,
             batch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Uniform draw: env ``e`` in ``[0, N)`` and absolute step ``s`` in
        ``[total − size + stack, total − n_step)``, both ``[B]`` int64."""
        lo, hi = self._draw_range(state)
        dev = state.frames.device
        e = torch.randint(0, self.num_envs, (batch_size,), generator=gen,
                          device=dev)
        s = torch.randint(lo, hi, (batch_size,), generator=gen, device=dev)
        return e, s

    @torch.no_grad()
    def sample_at(self, state: FrameReplayState, e: torch.Tensor,
                  s: torch.Tensor) -> TransitionBatch:
        """The batch for drawn envs ``e`` and absolute steps ``s``."""
        p = s % self.capacity
        ages = state.age[e, p]
        obs, next_obs = self._gather_union(state, e, s, ages)
        return TransitionBatch(
            obs=obs,
            act=state.act[e, p],
            next_obs=next_obs,
            reward=state.reward[e, p],
            terminated=state.terminated[e, p],
            truncated=state.truncated[e, p],
            weight=None,  # uniform: every sample weighs 1
            ix_sample=(e * self.capacity + p).to(torch.int32),
        )

    def sample(self, state: FrameReplayState, gen: torch.Generator,
               batch_size: int, n_opts: Optional[int] = None) -> TransitionBatch:
        return self.sample_at(state, *self.draw(state, gen, batch_size))

    def update_priority(self, state, ix_sample, td_err):
        """No-op: replay is uniform."""
        return state

    def diagnostics(self, state: FrameReplayState) -> Dict[str, torch.Tensor]:
        size = min(state.total, self.capacity)
        return {
            "num_terminated": state.terminated[:, :size].sum(),
            "sum_rewards": state.reward[:, :size].sum(),
            "size": size * self.num_envs,
        }
