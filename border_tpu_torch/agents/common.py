"""Shared agent machinery: losses, target-network updates, optimizers
(≙ border_tpu/agents/common.py).

Parameters live in ``nn.Module``s; the target-network updates write the
target module's parameters in place.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from border_tpu_torch.envs.pixel import true_div
from border_tpu_torch.errors import ConfigError
from border_tpu_torch.models.mlp import EnsembleMLP
from border_tpu_torch.ops.adam import KernelAdam, KernelAdamW
from border_tpu_torch.utils import collectives
from border_tpu_torch.utils.counters import Count

# a learning rate: a constant, or a schedule of the optimizer's step count
LearningRate = Union[float, Callable[[int], float]]


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
    """τ-polyak soft update, in place: tgt ← τ·online + (1−τ)·tgt, three
    ``_foreach`` launches over all of the module's tensors (a stacked
    critic ensemble's ``[n, ...]`` ones too).  The same two products and
    one sum as the JAX version: ``_foreach_lerp_`` would launch once, but
    computes ``tgt + τ·(online − tgt)``, which rounds another way."""
    tgt = list(target.parameters())
    scaled = torch._foreach_mul(list(online.parameters()), tau)
    torch._foreach_mul_(tgt, 1.0 - tau)
    torch._foreach_add_(tgt, scaled)


@torch.no_grad()
def periodic_polyak(
    n_opts: Count, interval: int, tau: float, online: nn.Module,
    target: nn.Module,
) -> None:
    """Soft-update every ``interval`` optimizer steps.  With interval=1,
    τ=0.005 this is per-step polyak; with interval=10_000, τ=1.0 it is a
    hard DQN target swap.

    A host-int ``n_opts`` (the CPU path) branches on the host.  A device
    count (the CUDA path, which a graph replays) runs the update at every
    step with a masked τ: ``tgt·(1−τ') + online·τ'`` with τ' = τ on a sync
    step, else 0, so the target keeps its values off the sync steps and
    gets :func:`polyak_update`'s two products and one sum on them."""
    if not torch.is_tensor(n_opts):
        if n_opts % interval == 0:
            polyak_update(tau, online, target)
        return
    on = n_opts % interval == 0
    tgt = list(target.parameters())
    scaled = torch._foreach_mul(list(online.parameters()),
                                torch.where(on, tau, 0.0))
    torch._foreach_mul_(tgt, torch.where(on, 1.0 - tau, 1.0))
    torch._foreach_add_(tgt, scaled)


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule``, in float32 as optax computes it:
    ``init·((1−α)·½(1 + cos(π·min(k, T)/T)) + α)`` at step count k."""
    if not decay_steps > 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")
    f32 = np.float32

    def schedule(count: Count):
        if torch.is_tensor(count):  # a device count: the same steps on it
            k = count.clamp_max(decay_steps).float() * float(f32(np.pi))
            cosine = (torch.cos(true_div(k, float(decay_steps))) + 1.0) * 0.5
            return ((cosine * float(f32(1 - alpha)) + float(f32(alpha)))
                    * float(f32(init_value)))
        k = f32(min(count, decay_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * k / f32(decay_steps)))
        return float(f32(init_value) * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule


def lr_at(lr: LearningRate, count: Count):
    """The learning rate of the update that follows ``count`` updates: optax
    evaluates a schedule at the step count before its increment."""
    return lr(count) if callable(lr) else lr


def set_lr(opt: torch.optim.Optimizer, lr) -> None:
    """Each parameter group's rate set to ``lr``: written into the group's
    rate tensor where it has one (a capturable optimizer on the card, whose
    step a graph replays), else stored as a Python float."""
    for group in opt.param_groups:
        if torch.is_tensor(group["lr"]):
            if torch.is_tensor(lr):
                group["lr"].copy_(lr)
            else:
                group["lr"].fill_(lr)
        elif torch.is_tensor(lr) and lr.is_cuda:
            # a Python rate would be frozen into a captured graph
            raise ConfigError(
                "a learning-rate schedule on the card needs a capturable "
                "optimizer with a rate tensor ('adam' or 'adamw')")
        else:
            group["lr"] = float(lr)


@torch.no_grad()
def maybe_pmean(params: Iterable[torch.Tensor], group) -> None:
    """The gradients of ``params`` averaged over the process ``group``, in
    place: the data-parallel learner's reduction (≙ ``maybe_pmean``, a
    ``pmean`` over the mesh axis).  ``group`` None: no reduction.  One
    all-reduce per gradient dtype, over the gradients laid end to end."""
    if group is None:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = collectives.mean_(torch.cat([g.reshape(-1) for g in grads]), group)
        torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(
            flat.split([g.numel() for g in grads]), grads)])


def minimize(opt: torch.optim.Optimizer, loss: torch.Tensor,
             lr: Optional[LearningRate] = None, count: Count = 0,
             inputs: Optional[List[torch.Tensor]] = None,
             group=None) -> None:
    """One step of ``opt`` on ``loss``: zero the grads, backpropagate (into
    ``inputs`` alone when given), average the gradients over ``group``
    (:func:`maybe_pmean`), step.  A schedule ``lr`` sets the rate
    ``lr(count)`` first: of a host int on the CPU, of the device count on
    the card (:func:`set_lr`), so neither costs a sync."""
    opt.zero_grad(set_to_none=True)
    loss.backward(inputs=inputs)
    maybe_pmean((p for g in opt.param_groups for p in g["params"]), group)
    if callable(lr):
        set_lr(opt, lr(count))
    opt.step()


def param_generator(seed_or_gen) -> torch.Generator:
    """The CPU generator parameters are drawn from: an int seeds a new one,
    so a seed gives the same network on every device."""
    if isinstance(seed_or_gen, torch.Generator):
        return seed_or_gen
    return torch.Generator().manual_seed(int(seed_or_gen))


def critic_input(obs: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    """obs ‖ act, the input of a Q-critic."""
    return torch.cat([obs, act.reshape(act.shape[0], -1)], dim=-1)


def new_critics(gen: torch.Generator, n: int, in_dim: int,
                hidden: Sequence[int], device) -> Tuple[EnsembleMLP, EnsembleMLP]:
    """An ensemble of ``n`` Q-critics and a frozen copy as its target."""
    critic = EnsembleMLP(n, in_dim, 1, tuple(hidden))
    critic.reset_parameters(gen)
    critic = critic.to(device)
    target = copy.deepcopy(critic)
    target.requires_grad_(False)
    return critic, target


def weighted_mean(weight: Optional[torch.Tensor],
                  per: torch.Tensor) -> torch.Tensor:
    """``mean(weight · per)``, ``weight`` [B] broadcast over the last axis
    (None: all ones)."""
    return (per if weight is None else weight * per).mean()


def make_optimizer(
    name: str = "adam", lr: LearningRate = 1e-3, **kw
) -> Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]:
    """Factory ``params -> torch.optim.Optimizer`` computing what the
    matching ``optax`` transform computes: ``adam`` is b1 0.9, b2 0.999,
    eps 1e-8 outside the sqrt, no eps_root, bias-corrected; ``adamw`` adds
    optax's default decoupled weight decay 1e-4; ``sgd`` is plain SGD.
    ``lr`` may be a schedule; the optimizer then starts at ``lr(0)`` and
    :func:`minimize` sets each step's rate.

    Over parameters on a CUDA device, Adam and AdamW are
    :class:`~border_tpu_torch.ops.adam.KernelAdam` and ``KernelAdamW``:
    torch's optimizers with ``capturable=True`` and a float32 rate tensor
    (their step count, bias corrections and rate stay on the device, so a
    CUDA graph can replay the step), each step one launch of the
    hand-written kernel ``csrc/adam.cu``, bit for bit torch's step.  The
    eager path on the card uses the same optimizer, so eager and replayed
    updates are the same program."""
    lr = lr_at(lr, 0)
    betas = (kw.get("b1", 0.9), kw.get("b2", 0.999))
    eps = kw.get("eps", 1e-8)

    def adam(cls, kernel_cls, params, **extra):
        params = list(params)
        dev = params[0].device if params else torch.device("cpu")
        if dev.type != "cuda":
            return cls(params, lr=lr, betas=betas, eps=eps, **extra)
        return kernel_cls(params, lr=torch.tensor(lr, dtype=torch.float32, device=dev),
                          betas=betas, eps=eps, capturable=True, **extra)

    if name == "adam":
        return lambda p: adam(torch.optim.Adam, KernelAdam, p)
    if name == "adamw":
        return lambda p: adam(torch.optim.AdamW, KernelAdamW, p,
                              weight_decay=kw.get("weight_decay", 1e-4))
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
def clip_grads_(params: Iterable[torch.Tensor], max_norm: float) -> None:
    """:func:`clip_by_global_norm_` over the gradients of ``params``.  A
    column-sharded parameter (``tp_group``: the name of its model group,
    set by the port's GSPMDTrainer) holds a block of its tensor: the
    squares of those blocks are summed over the model group, and the
    replicated parameters count once."""
    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]
    groups = {getattr(p, "tp_group", None) for p in params} - {None}
    if not groups:
        clip_by_global_norm_(grads, max_norm)
        return
    (name,) = groups
    sq = torch.stack(torch._foreach_norm(grads)).square()
    sharded = torch.tensor([getattr(p, "tp_group", None) is not None
                            for p in params], device=sq.device)
    sq_sharded = collectives.all_reduce_(
        torch.where(sharded, sq, 0.0).sum(), collectives.group_by_name(name))
    norm = (sq_sharded + torch.where(sharded, 0.0, sq).sum()).sqrt()
    torch._foreach_mul_(grads, torch.where(norm < max_norm, 1.0, max_norm / norm))


@torch.no_grad()
def param_stats(params: nn.Module, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Per-tensor mean/std records (≙ param_stats, util.rs:66-80)."""
    out = {}
    for name, p in params.named_parameters():
        out[f"{prefix}{name}_mean"] = p.mean()
        out[f"{prefix}{name}_std"] = p.float().std(unbiased=False)
    return out


def gamma_not_done(gamma: float, terminated: torch.Tensor) -> torch.Tensor:
    """Bootstrap mask: γ·(1−terminated) in float32.  Truncated episodes
    still bootstrap (≙ gamma_not_done, border-candle-agent/src/util.rs;
    dqn/base.rs:91-105 uses only is_terminated)."""
    return gamma * (1.0 - terminated.to(torch.float32))


def bootstrap_discount(gamma: float, batch) -> torch.Tensor:
    """Bootstrap factor for a sampled batch: γ·(1−terminated) for 1-step
    batches, or the buffer-provided γ^m·(1−terminated) when the batch
    carries n-step discounts."""
    not_done = 1.0 - batch.terminated.float()
    if getattr(batch, "discount", None) is not None:
        return batch.discount * not_done
    return gamma * not_done
