"""DQN agent: double DQN, ε-greedy/softmax exploration
(≙ border_tpu/agents/dqn.py).

- critic update: target ``r + γ·(1−terminated)·Q'`` with the double-DQN
  argmax switch, smooth-L1 or MSE loss, importance weights,
- exploration: ε-greedy with linear decay eps_start→eps_final over
  ``eps_final_step`` env steps, or softmax (multinomial over Q logits),
- target update every ``soft_update_interval`` optimizer steps by τ-polyak
  (τ=1 is the hard swap).

The state holds the online and target networks as ``nn.Module``s and a
``torch.optim`` optimizer; ``update`` steps them in place and returns the
same state.  ``n_opts`` and ``n_samples`` are host ints: both advance by a
fixed amount per call, so the ε and learning-rate schedules and the target
cadence need no device→host sync.  On a CUDA device the state also holds
them as a device tensor (:mod:`border_tpu_torch.utils.counters`), which the
schedules and the target cadence read there, so a CUDA graph of an update
or an env step replays them.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from border_tpu_torch.agents.common import (
    CRITIC_LOSSES,
    bootstrap_discount,
    clip_grads_,
    make_optimizer,
    maybe_pmean,
    param_generator,
    periodic_polyak,
    set_lr,
)
from border_tpu_torch.core import spaces
from border_tpu_torch.core.agent import Agent
from border_tpu_torch.errors import ConfigError
from border_tpu_torch.models.mlp import MLP, DuelingMLP
from border_tpu_torch.replay.buffer import TransitionBatch
from border_tpu_torch.utils import profiling
from border_tpu_torch.utils.counters import (
    Count,
    advance,
    count,
    linear_f32,
    new_counts,
)
from border_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    """≙ DqnConfig (border-tch-agent/src/dqn/config.rs:26-219)."""

    gamma: float = 0.99
    tau: float = 0.005
    soft_update_interval: int = 1
    double_dqn: bool = False
    loss: str = "smooth_l1"  # "smooth_l1" | "mse"
    explorer: str = "epsilon_greedy"  # "epsilon_greedy" | "softmax"
    eps_start: float = 1.0
    eps_final: float = 0.02
    eps_final_step: int = 100_000
    optimizer: str = "adam"
    lr: float = 1e-3
    # linear lr decay lr → lr·lr_final_frac over lr_decay_steps optimizer
    # steps (None: constant lr)
    lr_decay_steps: Optional[int] = None
    lr_final_frac: float = 0.05
    max_grad_norm: Optional[float] = None
    hidden: Sequence[int] = (64, 64)
    dueling: bool = False
    # ``n_actions -> nn.Module`` factory, e.g. ``lambda n: AtariCNN(n)``;
    # None builds an MLP (or, with ``dueling``, a DuelingMLP) of ``hidden``
    model: Any = None
    # kept so configs carry over; both forwards of the double-DQN target
    # are plain forwards here ("stacked" and "separate" give the same values)
    next_forward: Optional[str] = None
    # clip per-transition rewards to [-c, c] at update time (1-step only)
    clip_reward: Optional[float] = None


@dataclasses.dataclass
class DQNState:
    """``params``/``target_params``: the online and target networks;
    ``opt_state``: the optimizer over ``params``."""

    params: nn.Module
    target_params: nn.Module
    opt_state: torch.optim.Optimizer
    n_opts: int  # optimizer steps
    n_samples: int  # env steps seen (drives ε decay)
    # (n_opts, n_samples) on a CUDA device, None on the CPU
    counts: Optional[torch.Tensor] = None

    COUNTERS = ("n_opts", "n_samples")


class DQN(Agent):
    name = "dqn"

    def __init__(self, config: DQNConfig = DQNConfig()):
        if config.next_forward not in (None, "stacked", "separate"):
            raise ConfigError(
                f"next_forward must be 'stacked', 'separate', or None "
                f"(auto), got {config.next_forward!r}"
            )
        if config.loss not in CRITIC_LOSSES:
            raise ConfigError(f"unknown loss {config.loss!r}")
        self.config = config
        self.make_opt = make_optimizer(config.optimizer, config.lr)

    # -- construction ------------------------------------------------------
    def init(self, seed_or_gen, obs_space: spaces.Space,
             act_space: spaces.Discrete, device=None) -> DQNState:
        """Parameters are drawn on the CPU from ``seed_or_gen`` (an int or a
        CPU ``torch.Generator``), so a seed gives the same network on every
        device, then moved to ``device`` (``None`` = the GPU)."""
        device = resolve_device(device)
        gen = param_generator(seed_or_gen)
        c = self.config
        if c.model is not None:
            net = c.model(act_space.n)
        else:
            mlp = DuelingMLP if c.dueling else MLP
            net = mlp(in_dim=obs_space.flat_dim, out_dim=act_space.n,
                      hidden=tuple(c.hidden))
        if hasattr(net, "reset_parameters"):
            net.reset_parameters(gen)
        net = net.to(device)
        target = copy.deepcopy(net)
        target.requires_grad_(False)
        return DQNState(
            params=net,
            target_params=target,
            opt_state=self.make_opt(net.parameters()),
            n_opts=0,
            n_samples=0,
            counts=new_counts(device, (0, 0)),
        )

    # -- acting ------------------------------------------------------------
    def epsilon(self, state: DQNState):
        """Linear decay, in float32 like the JAX version: a float on the
        CPU, a device scalar on the card."""
        c = self.config
        return linear_f32(count(state, "n_samples"), c.eps_final_step,
                          c.eps_start, c.eps_final)

    @torch.no_grad()
    def select_action(self, state: DQNState, obs: torch.Tensor,
                      gen: torch.Generator) -> torch.Tensor:
        q = state.params(obs)  # [B, A]
        if self.config.explorer == "softmax":
            # torch.multinomial's own one-draw path (argmax of p over
            # exponential draws) without its host-side validity check,
            # which syncs and so cannot be captured: the same actions
            p = torch.softmax(q, dim=-1)
            e = torch.empty_like(p).exponential_(1, generator=gen)
            return torch.argmax(p / e, dim=-1).to(torch.int32)
        greedy = torch.argmax(q, dim=-1).to(torch.int32)
        random = torch.randint(0, q.shape[-1], greedy.shape, generator=gen,
                               device=q.device, dtype=torch.int32)
        explore = torch.rand(greedy.shape, generator=gen,
                             device=q.device) < self.epsilon(state)
        return torch.where(explore, random, greedy)

    @torch.no_grad()
    def select_action_eval(self, state: DQNState, obs: torch.Tensor,
                           gen: Optional[torch.Generator] = None) -> torch.Tensor:
        return torch.argmax(state.params(obs), dim=-1).to(torch.int32)

    def on_env_step(self, state: DQNState, n: int) -> DQNState:
        advance(state, "n_samples", n)
        return state

    # -- learning (≙ update_critic, dqn/base.rs:60-160) --------------------
    def _lr(self, n_opts: Count):
        """optax.linear_schedule at update count ``n_opts``: of a host int
        in double precision, of a device count in float32."""
        c = self.config
        if not c.lr_decay_steps:
            return c.lr
        if torch.is_tensor(n_opts):
            return linear_f32(n_opts, c.lr_decay_steps, c.lr,
                              c.lr * c.lr_final_frac)
        frac = min(n_opts, c.lr_decay_steps) / c.lr_decay_steps
        return c.lr + frac * (c.lr * c.lr_final_frac - c.lr)

    def update(
        self, state: DQNState, batch: TransitionBatch,
        gen: Optional[torch.Generator] = None,
    ) -> Tuple[DQNState, Dict[str, Any], torch.Tensor]:
        c = self.config
        obs, act, next_obs, reward, terminated, _trunc, _ix, weight = batch.unpack()
        cuda = reward.is_cuda
        net, tgt_net, opt = state.params, state.target_params, state.opt_state

        with profiling.detail("update.forward", cuda):
            act = act.long()
            reward = reward.float()
            if c.clip_reward is not None:
                reward = torch.clamp(reward, -c.clip_reward, c.clip_reward)
            with torch.no_grad():
                q_next_tgt = tgt_net(next_obs)  # [B, A]
                if c.double_dqn:
                    # argmax from the online net, value from the target net
                    a_star = torch.argmax(net(next_obs), dim=-1)
                else:
                    a_star = torch.argmax(q_next_tgt, dim=-1)
                q_next = q_next_tgt.gather(1, a_star[:, None])[:, 0]
                target = reward + bootstrap_discount(c.gamma, batch) * q_next

            q = net(obs)
            pred = q.gather(1, act[:, None])[:, 0]
            per_elem = CRITIC_LOSSES[c.loss](pred, target)
            loss = (per_elem if weight is None else weight * per_elem).mean()

        with profiling.detail("update.backward", cuda):
            opt.zero_grad(set_to_none=True)
            loss.backward()
            # averaged over the data-parallel group first, clipped after: in
            # the JAX agent the clip is the first stage of the optimizer chain
            maybe_pmean(net.parameters(), self.axis_group)
        with profiling.detail("update.optimizer", cuda):
            if c.max_grad_norm is not None:
                clip_grads_(net.parameters(), c.max_grad_norm)
            if c.lr_decay_steps:
                set_lr(opt, self._lr(count(state, "n_opts")))
            opt.step()
            advance(state, "n_opts", 1)
        with profiling.detail("update.target", cuda):
            periodic_polyak(count(state, "n_opts"), c.soft_update_interval,
                            c.tau, net, tgt_net)
        pred = pred.detach()
        metrics = {
            "loss": loss.detach(),
            "q_mean": pred.mean(),
            "epsilon": self.epsilon(state),
        }
        return state, metrics, pred - target

