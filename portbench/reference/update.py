"""The pieces of a plain update that the agent kinds (:mod:`.kinds`)
share, float32, one batch at a time: the Huber loss, the batch's mean
and Adam.

Adam (Kingma & Ba 2015): β 0.9 / 0.999, ε 1e-8 outside the root,
bias-corrected.  ``half`` is a planted fault: the loss's mean over the
first half of the batch only.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def huber(d: torch.Tensor, kappa: float = 1.0) -> torch.Tensor:
    a = d.abs()
    return torch.where(a <= kappa, 0.5 * d * d, kappa * (a - 0.5 * kappa))


def batch_mean(per: torch.Tensor, weight: Optional[torch.Tensor], half: bool):
    """The mean of the per-sample losses ``per``, weighted by the importance
    weights where replay is prioritized (``half``: over the first half)."""
    if weight is not None:
        per = weight * per
    return per[: per.shape[0] // 2].mean() if half else per.mean()


class Adam:
    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.t = 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, p: Dict[str, torch.Tensor], g: Dict[str, torch.Tensor]):
        self.t += 1
        for k, grad in g.items():
            m = self.m.get(k, torch.zeros_like(grad))
            v = self.v.get(k, torch.zeros_like(grad))
            m = self.b1 * m + (1 - self.b1) * grad
            v = self.b2 * v + (1 - self.b2) * grad * grad
            self.m[k], self.v[k] = m, v
            m_hat = m / (1 - self.b1 ** self.t)
            v_hat = v / (1 - self.b2 ** self.t)
            p[k] -= self.lr * m_hat / (v_hat.sqrt() + self.eps)
