"""Transition containers (≙ border_tpu/replay/buffer.py).

``Transition``, ``TransitionBatch`` and ``PerConfig`` are ported; the flat
``ReplayBuffer`` follows with ROADMAP A.10.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch


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

    def beta(self, n_opts: int) -> float:
        """Linear β annealing (≙ IwScheduler::beta, iw_scheduler.rs:6-46) on
        a host int, in float32 like the JAX version."""
        f32 = np.float32
        frac = np.clip(f32(n_opts) / f32(self.n_opts_final), f32(0), f32(1))
        return float(f32(self.beta_0) + frac * f32(self.beta_final - self.beta_0))
