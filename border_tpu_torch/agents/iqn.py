"""Implicit Quantile Networks agent (≙ border_tpu/agents/iqn.py).

- quantile model: ψ features ⊙ φ cosine embedding → f merge net
  (:class:`border_tpu_torch.models.iqn.IQNNet`),
- τ-sampling strategies: ``uniform{K}``, ``const{K}`` (midpoint grid),
  ``median``,
- critic update: greedy next action by argmax of the τ-averaged TARGET Q,
  target quantiles ``r + γ(1−terminated)·Z'(s', a*)``, quantile Huber loss
  between predicted quantiles at τ_pred and target quantiles at τ_tgt,
- ε-greedy over τ-averaged action values (same explorer semantics as DQN),
- τ-polyak soft update every ``soft_update_interval`` optimizer steps.

As in the port's DQN the state holds ``nn.Module``s and a ``torch.optim``
optimizer stepped in place, and ``n_opts``/``n_samples`` are host ints
with a device twin on the card (:mod:`border_tpu_torch.utils.counters`).
An update draws three sets of τ and an action one; ``update`` takes them
ready-made through ``taus`` so a test can feed both packages the same.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from border_tpu_torch.agents.common import (
    bootstrap_discount,
    make_optimizer,
    maybe_pmean,
    param_generator,
    periodic_polyak,
    quantile_huber_loss,
)
from border_tpu_torch.core import spaces
from border_tpu_torch.core.agent import Agent
from border_tpu_torch.models.iqn import IQNNet
from border_tpu_torch.replay.buffer import TransitionBatch
from border_tpu_torch.utils import profiling
from border_tpu_torch.utils.counters import advance, count, linear_f32, new_counts
from border_tpu_torch.utils.device import resolve_device


@functools.lru_cache(maxsize=None)
def _midpoints(k: int, device) -> torch.Tensor:
    """``(i + 0.5) / k`` for ``i < k``, divided on the host and made once
    per device (a CUDA division by a Python number multiplies by the
    reciprocal and can round the last bit another way)."""
    return ((torch.arange(k, dtype=torch.float32) + 0.5) / k).to(device)


def sample_taus(strategy: str, gen: Optional[torch.Generator], batch: int,
                device) -> torch.Tensor:
    """Quantile fractions ``[batch, K]`` float32; only ``uniform{K}`` draws
    from ``gen``."""
    if strategy.startswith("uniform"):
        k = int(strategy[len("uniform"):])
        return torch.rand((batch, k), generator=gen, device=device)
    if strategy.startswith("const"):
        k = int(strategy[len("const"):])
        return _midpoints(k, torch.device(device)).expand(batch, k)
    if strategy == "median":
        return torch.full((batch, 1), 0.5, device=device)
    raise ValueError(f"unknown tau strategy {strategy!r}")


@dataclasses.dataclass(frozen=True)
class IQNConfig:
    """≙ IqnConfig (border-tch-agent/src/iqn/config.rs:56-60 defaults)."""

    gamma: float = 0.99
    tau: float = 0.005
    soft_update_interval: int = 1
    sample_percents_pred: str = "uniform8"
    sample_percents_tgt: str = "uniform8"
    sample_percents_act: str = "const32"
    kappa: float = 1.0  # Huber threshold
    # exploration (shared DQN ε-greedy semantics)
    eps_start: float = 1.0
    eps_final: float = 0.02
    eps_final_step: int = 100_000
    optimizer: str = "adam"
    lr: float = 1e-3
    feature_dim: int = 64
    n_cos: int = 64
    hidden: Sequence[int] = (64,)
    # factory of a ψ feature module with no arguments, e.g.
    # ``partial(AtariCNN, out_dim=0, skip_linear=True)``; None: an MLP
    psi_fn: Any = None


@dataclasses.dataclass
class IQNState:
    params: nn.Module
    target_params: nn.Module
    opt_state: torch.optim.Optimizer
    n_opts: int
    n_samples: int
    counts: Optional[torch.Tensor] = None  # on a CUDA device

    COUNTERS = ("n_opts", "n_samples")


class IQN(Agent):
    name = "iqn"

    def __init__(self, config: IQNConfig = IQNConfig()):
        self.config = config
        self.make_opt = make_optimizer(config.optimizer, config.lr)

    def init(self, seed_or_gen, obs_space: spaces.Space,
             act_space: spaces.Discrete, device=None) -> IQNState:
        """Parameters are drawn on the CPU from ``seed_or_gen``, then moved
        to ``device`` (``None`` = the GPU), as in :meth:`DQN.init`."""
        c = self.config
        device = resolve_device(device)
        gen = param_generator(seed_or_gen)
        net = IQNNet(
            in_dim=obs_space.flat_dim,
            out_dim=act_space.n,
            feature_dim=c.feature_dim,
            n_cos=c.n_cos,
            psi_hidden=tuple(c.hidden),
            f_hidden=tuple(c.hidden),
            psi_fn=c.psi_fn,
        )
        net.reset_parameters(gen)
        net = net.to(device)
        target = copy.deepcopy(net)
        target.requires_grad_(False)
        return IQNState(
            params=net,
            target_params=target,
            opt_state=self.make_opt(net.parameters()),
            n_opts=0,
            n_samples=0,
            counts=new_counts(device, (0, 0)),
        )

    # -- acting: ε-greedy over τ-averaged Q --------------------------------
    def _avg_q(self, net: nn.Module, obs, gen, taus=None) -> torch.Tensor:
        if taus is None:
            taus = sample_taus(self.config.sample_percents_act, gen,
                               obs.shape[0], obs.device)
        return net(obs, taus).mean(dim=1)  # [B, K, A] → [B, A]

    def epsilon(self, state: IQNState):
        """Linear decay, in float32 like the JAX version: a float on the
        CPU, a device scalar on the card."""
        c = self.config
        return linear_f32(count(state, "n_samples"), c.eps_final_step,
                          c.eps_start, c.eps_final)

    @torch.no_grad()
    def select_action(self, state: IQNState, obs: torch.Tensor,
                      gen: torch.Generator) -> torch.Tensor:
        q = self._avg_q(state.params, obs, gen)
        greedy = torch.argmax(q, dim=-1).to(torch.int32)
        random = torch.randint(0, q.shape[-1], greedy.shape, generator=gen,
                               device=q.device, dtype=torch.int32)
        explore = torch.rand(greedy.shape, generator=gen,
                             device=q.device) < self.epsilon(state)
        return torch.where(explore, random, greedy)

    @torch.no_grad()
    def select_action_eval(self, state: IQNState, obs: torch.Tensor,
                           gen: Optional[torch.Generator] = None) -> torch.Tensor:
        return torch.argmax(self._avg_q(state.params, obs, gen),
                            dim=-1).to(torch.int32)

    def on_env_step(self, state: IQNState, n: int) -> IQNState:
        advance(state, "n_samples", n)
        return state

    # -- learning ----------------------------------------------------------
    def update(
        self, state: IQNState, batch: TransitionBatch,
        gen: Optional[torch.Generator] = None,
        taus: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    ) -> Tuple[IQNState, Dict[str, Any], torch.Tensor]:
        """``taus``: ``(pred, tgt, act)`` quantile fractions in place of the
        three draws from ``gen``."""
        c = self.config
        obs, act, next_obs, reward, terminated, _trunc, _ix, weight = batch.unpack()
        B, dev = reward.shape[0], reward.device
        cuda = dev.type == "cuda"
        net, tgt_net, opt = state.params, state.target_params, state.opt_state

        with profiling.detail("update.forward", cuda):
            act = act.long()
            reward = reward.float()
            if taus is None:
                taus = tuple(sample_taus(s, gen, B, dev) for s in (
                    c.sample_percents_pred, c.sample_percents_tgt,
                    c.sample_percents_act))
            taus_pred, taus_tgt, taus_act = taus
            with torch.no_grad():
                # next action: argmax of the τ-averaged target Q
                a_star = torch.argmax(
                    self._avg_q(tgt_net, next_obs, gen, taus_act), dim=-1)
                z_next = tgt_net(next_obs, taus_tgt)  # [B, Kt, A]
                z_next_a = z_next.gather(
                    2, a_star[:, None, None].expand(-1, z_next.shape[1], 1)
                )[..., 0]  # [B, Kt]
                tgt = (reward[:, None]
                       + bootstrap_discount(c.gamma, batch)[:, None] * z_next_a)

            z = net(obs, taus_pred)  # [B, Kp, A]
            pred = z.gather(2, act[:, None, None].expand(-1, z.shape[1], 1))[..., 0]
            per_sample = quantile_huber_loss(pred, tgt, taus_pred, c.kappa)
            loss = (per_sample if weight is None else weight * per_sample).mean()

        with profiling.detail("update.backward", cuda):
            opt.zero_grad(set_to_none=True)
            loss.backward()
            maybe_pmean(net.parameters(), self.axis_group)
        with profiling.detail("update.optimizer", cuda):
            opt.step()
            advance(state, "n_opts", 1)
        with profiling.detail("update.target", cuda):
            periodic_polyak(count(state, "n_opts"), c.soft_update_interval,
                            c.tau, net, tgt_net)
        pred = pred.detach()
        # PER priority: mean TD over quantile pairs
        td_err = pred.mean(dim=1) - tgt.mean(dim=1)
        metrics = {
            "loss": loss.detach(),
            "q_mean": pred.mean(),
            "epsilon": self.epsilon(state),
        }
        return state, metrics, td_err

