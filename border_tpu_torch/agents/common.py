"""Shared agent machinery: losses, target-network updates, optimizers
(≙ border_tpu/agents/common.py).

Parameters live in ``nn.Module``s; the target-network updates write the
target module's parameters in place.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable

import torch
from torch import nn


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-element smooth-L1 (Huber δ=1), ≙ CriticLoss::SmoothL1."""
    d = pred - target
    a = torch.abs(d)
    return torch.where(a < 1.0, 0.5 * d * d, a - 0.5)


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target) ** 2


CRITIC_LOSSES = {"smooth_l1": smooth_l1, "mse": mse}


def quantile_huber_loss(
    pred: torch.Tensor, tgt: torch.Tensor, taus: torch.Tensor,
    kappa: float = 1.0,
) -> torch.Tensor:
    """Quantile Huber loss between pred quantiles [B, Kp] at fractions
    ``taus`` [B, Kp] and target quantiles [B, Kt].

    Returns the per-sample loss [B]: mean over target quantiles, sum over
    predicted quantiles (the IQN paper's convention).
    """
    # pairwise TD errors u[b, kp, kt] = tgt[b, kt] - pred[b, kp]
    u = tgt[:, None, :] - pred[:, :, None]
    a = torch.abs(u)
    huber = torch.where(a <= kappa, 0.5 * u * u, kappa * (a - 0.5 * kappa))
    indicator = (u < 0.0).float()
    loss = torch.abs(taus[:, :, None] - indicator) * huber / kappa
    return loss.mean(dim=2).sum(dim=1)


@torch.no_grad()
def polyak_update(tau: float, online: nn.Module, target: nn.Module) -> None:
    """τ-polyak soft update, in place: tgt ← τ·online + (1−τ)·tgt
    (the same two products and one sum as the JAX version)."""
    tgt = list(target.parameters())
    scaled = torch._foreach_mul(list(online.parameters()), tau)
    torch._foreach_mul_(tgt, 1.0 - tau)
    torch._foreach_add_(tgt, scaled)


def periodic_polyak(
    n_opts: int, interval: int, tau: float, online: nn.Module,
    target: nn.Module,
) -> None:
    """Soft-update every ``interval`` optimizer steps.  With interval=1,
    τ=0.005 this is per-step polyak; with interval=10_000, τ=1.0 it is a
    hard DQN target swap.  ``n_opts`` is a host int, so the test costs no
    device sync."""
    if n_opts % interval == 0:
        polyak_update(tau, online, target)


def make_optimizer(
    name: str = "adam", lr: float = 1e-3, **kw
) -> Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]:
    """Factory ``params -> torch.optim.Optimizer`` computing what the
    matching ``optax`` transform computes: ``adam`` is b1 0.9, b2 0.999,
    eps 1e-8 outside the sqrt, no eps_root, bias-corrected; ``adamw`` adds
    optax's default decoupled weight decay 1e-4; ``sgd`` is plain SGD."""
    if name == "adam":
        return lambda p: torch.optim.Adam(
            p, lr=lr, betas=(kw.get("b1", 0.9), kw.get("b2", 0.999)),
            eps=kw.get("eps", 1e-8),
        )
    if name == "adamw":
        return lambda p: torch.optim.AdamW(
            p, lr=lr, betas=(kw.get("b1", 0.9), kw.get("b2", 0.999)),
            eps=kw.get("eps", 1e-8), weight_decay=kw.get("weight_decay", 1e-4),
        )
    if name == "sgd":
        return lambda p: torch.optim.SGD(p, lr=lr)
    raise ValueError(f"unknown optimizer {name!r}")


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> None:
    """optax's ``clip_by_global_norm``, in place and without a host sync:
    g ← g·max/‖g‖ when ‖g‖ ≥ max, else unchanged."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)


@torch.no_grad()
def param_stats(params: nn.Module, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Per-tensor mean/std records (≙ param_stats, util.rs:66-80)."""
    out = {}
    for name, p in params.named_parameters():
        out[f"{prefix}{name}_mean"] = p.mean()
        out[f"{prefix}{name}_std"] = p.float().std(unbiased=False)
    return out


def bootstrap_discount(gamma: float, batch) -> torch.Tensor:
    """Bootstrap factor for a sampled batch: γ·(1−terminated) for 1-step
    batches, or the buffer-provided γ^m·(1−terminated) when the batch
    carries n-step discounts."""
    not_done = 1.0 - batch.terminated.float()
    if getattr(batch, "discount", None) is not None:
        return batch.discount * not_done
    return gamma * not_done
