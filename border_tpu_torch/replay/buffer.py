"""Transition containers (≙ border_tpu/replay/buffer.py).

Only ``Transition`` and ``TransitionBatch`` are ported so far; the flat
``ReplayBuffer`` follows in a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

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
    bootstrap factor γ^m (None for 1-step batches).  ``weight`` None means
    uniform replay: every sample weighs 1.
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
