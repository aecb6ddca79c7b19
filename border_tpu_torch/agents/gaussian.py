"""Gaussian policy helpers shared by the actor-critic agents
(≙ border_tpu/agents/gaussian.py).

Clamped log-std Gaussians with a Tanh or Clamp action limit: ``sample``
and ``logp_of`` with the atanh / log-Jacobian correction for the tanh
limit.  Where the JAX helpers draw from a key, ``sample`` draws from a
``torch.Generator`` or takes the standard-normal draws ``z`` as given.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

LOG_2 = 0.6931471805599453
HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` returns x
    itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def tanh_log_det(u: torch.Tensor) -> torch.Tensor:
    """Σ_dims log(1 − tanh²(u)) in the stable form 2·(log 2 − u −
    softplus(−2u))."""
    return (2.0 * (LOG_2 - u - softplus(-2.0 * u))).sum(-1)


def normal_logp(u: torch.Tensor, mean: torch.Tensor,
                log_std: torch.Tensor) -> torch.Tensor:
    """Σ_dims log N(u; mean, exp(log_std))."""
    z = (u - mean) / torch.exp(log_std)
    return (-0.5 * z**2 - log_std - HALF_LOG_2PI).sum(-1)


def standard_normal(gen: Optional[torch.Generator],
                    like: torch.Tensor) -> torch.Tensor:
    return torch.randn(like.shape, generator=gen, device=like.device,
                       dtype=like.dtype)


def sample(
    gen: Optional[torch.Generator],
    mean: torch.Tensor,
    log_std: torch.Tensor,
    limit: str = "clamp",
    low: float = -1.0,
    high: float = 1.0,
    z: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """An action and its log-prob under the action limit; ``z`` injects
    the standard-normal draws in place of ``gen``'s."""
    if z is None:
        z = standard_normal(gen, mean)
    u = mean + torch.exp(log_std) * z
    if limit == "tanh":
        return torch.tanh(u), normal_logp(u, mean, log_std) - tanh_log_det(u)
    return u.clamp(low, high), normal_logp(u, mean, log_std)


def logp_of(action: torch.Tensor, mean: torch.Tensor, log_std: torch.Tensor,
            limit: str = "clamp") -> torch.Tensor:
    """Log-prob of a given action (dataset actions in the advantage-weighted
    losses), inverting the tanh limit with atanh of the action clipped to
    ±0.999995."""
    if limit == "tanh":
        a = action.clamp(-0.999995, 0.999995)
        return normal_logp(torch.atanh(a), mean, log_std) - torch.log(
            1.0 - a**2 + 1e-6).sum(-1)
    return normal_logp(action, mean, log_std)
